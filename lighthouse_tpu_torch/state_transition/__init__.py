"""State transition (reference consensus/state_processing, SURVEY.md
section 2.2): the port's copy of lighthouse_tpu/state_transition --
per-slot/epoch/block processing, fork upgrades, the block replayer, the
signature-set builders, the batched BlockSignatureVerifier and genesis
from eth1 deposits. per_epoch_mesh waits (ROADMAP Queue 1 item 13)."""

from .block_signature_verifier import BlockSignatureVerifier  # noqa: F401
from .context import BlockProcessingError, ConsensusContext  # noqa: F401
from .genesis import (  # noqa: F401
    initialize_beacon_state_from_eth1,
    is_valid_genesis_state,
    try_genesis_from_eth1,
)
from .per_block import (  # noqa: F401
    BlockSignatureStrategy,
    per_block_processing,
    process_attestation,
    process_deposit,
)
from .per_epoch import process_epoch  # noqa: F401
from .per_slot import (  # noqa: F401
    clone_state,
    get_beacon_proposer_index,
    process_slot,
    process_slots,
)
from .replay import BlockReplayer  # noqa: F401
from .upgrades import upgrade_to_altair  # noqa: F401
