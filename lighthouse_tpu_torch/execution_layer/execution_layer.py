"""What block import learns about an execution payload (reference
execution_layer/src/lib.rs, fork_choice PayloadVerificationStatus): the
port's copy of the two classes of lighthouse_tpu/execution_layer/
execution_layer.py that chain/beacon_chain.py reads. The ExecutionLayer
facade and the engine round trip wait (ROADMAP Queue 1 item 14.8)."""

from __future__ import annotations

import enum


class PayloadVerificationStatus(str, enum.Enum):
    """What block import learns about a payload (reference
    fork_choice PayloadVerificationStatus / payload_status.rs)."""

    VERIFIED = "verified"
    OPTIMISTIC = "optimistic"
    IRRELEVANT = "irrelevant"  # pre-merge blocks / default payloads


class PayloadInvalid(ValueError):
    def __init__(self, msg: str, latest_valid_hash: bytes | None = None):
        super().__init__(msg)
        self.latest_valid_hash = latest_valid_hash
