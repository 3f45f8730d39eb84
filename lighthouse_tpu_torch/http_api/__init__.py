"""HTTP API (reference beacon_node/http_api + http_metrics + common/eth2,
SURVEY.md section 2.3): standard Beacon API handlers, stdlib HTTP server
with /metrics and SSE events, and the typed client that lets the
validator client cross the process boundary.

The port's copy of lighthouse_tpu/http_api/__init__.py.
"""

from ..serving import ServingConfig, ServingTier  # noqa: F401
from .api import ApiError, BeaconApi  # noqa: F401
from .client import BeaconNodeHttpClient, Eth2ClientError  # noqa: F401
from .server import BeaconApiServer  # noqa: F401
