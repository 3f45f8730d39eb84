"""State transition (reference consensus/state_processing, SURVEY.md
section 2.2): the port's copy of lighthouse_tpu/state_transition so far --
per-slot processing within an epoch, the signature-set builders, and the
batched BlockSignatureVerifier. per_block, per_epoch, genesis, replay and
upgrades wait (ROADMAP Queue 1 item 14.2)."""

from .block_signature_verifier import BlockSignatureVerifier  # noqa: F401
from .context import BlockProcessingError, ConsensusContext  # noqa: F401
from .per_slot import (  # noqa: F401
    clone_state,
    get_beacon_proposer_index,
    process_slot,
    process_slots,
)
