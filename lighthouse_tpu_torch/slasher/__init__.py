"""Slasher (reference slasher/ + slasher/service, SURVEY.md section 2.4):
batched double-vote/surround/double-proposal detection feeding the
operation pool.

The port's copy of lighthouse_tpu/slasher/__init__.py.
"""

from .service import SlasherService  # noqa: F401
from .slasher import Slasher  # noqa: F401
