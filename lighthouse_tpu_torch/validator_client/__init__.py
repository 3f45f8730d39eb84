"""Validator client (reference validator_client/, SURVEY.md section 2.4):
the port's copy of lighthouse_tpu/validator_client in part. Here are the
in-process beacon node that block production runs through, the signing
store with slashing protection and doppelganger holds, and the Byzantine
store that bypasses the protection on purpose (the simulator's
adversaries). The duty services, the beacon-node fallback, the
keymanager and the web3signer wait (ROADMAP Queue 1 item 14.8, step 5)."""

from .beacon_node import InProcessBeaconNode  # noqa: F401
from .byzantine import (  # noqa: F401
    ByzPlan,
    ByzRoster,
    ByzantineValidatorStore,
    PlaceholderKeystore,
)
from .slashing_protection import NotSafe, SlashingDatabase  # noqa: F401
from .validator_store import (  # noqa: F401
    DoppelgangerHold,
    LocalKeystore,
    ValidatorStore,
)
