"""Validator client (reference validator_client/, SURVEY.md section 2.4):
duty services, signing store with slashing protection, beacon-node
fallback, doppelganger protection.

The port's copy of lighthouse_tpu/validator_client/__init__.py.
"""

from .beacon_node import InProcessBeaconNode  # noqa: F401
from .byzantine import (  # noqa: F401
    ByzPlan,
    ByzRoster,
    ByzantineValidatorStore,
    PlaceholderKeystore,
)
from .keymanager import KeymanagerApi, KeymanagerServer  # noqa: F401
from .services import (  # noqa: F401
    BeaconNodeFallback,
    DutiesService,
    NoHealthyBeaconNode,
    ValidatorClient,
)
from .signing_method import (  # noqa: F401
    Web3SignerError,
    Web3SignerMethod,
    Web3SignerServer,
)
from .slashing_protection import NotSafe, SlashingDatabase  # noqa: F401
from .validator_store import (  # noqa: F401
    DoppelgangerHold,
    LocalKeystore,
    ValidatorStore,
)
