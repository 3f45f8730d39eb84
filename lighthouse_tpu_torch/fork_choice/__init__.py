"""Fork choice (reference consensus/fork_choice + consensus/proto_array,
SURVEY.md section 2.2): LMD-GHOST proto-array with vote tracking, proposer
boost, and checkpoint-gated head viability.

The port's copy of lighthouse_tpu/fork_choice/__init__.py."""

from .fork_choice import ForkChoice, ForkChoiceError  # noqa: F401
from .proto_array import (  # noqa: F401
    ProtoArray,
    ProtoArrayError,
    ProtoArrayForkChoice,
    VoteTracker,
)
