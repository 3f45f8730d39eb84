"""ExecutionLayer facade (reference execution_layer/src/lib.rs): the
consensus side's handle on an execution engine. Verb-level API used by the
chain:

  * notify_new_payload(payload) -> PayloadVerificationStatus -- wraps
    engine_newPayload and interprets PayloadStatusV1 the way
    payload_status.rs does (SYNCING/ACCEPTED => optimistic import).
  * notify_forkchoice_updated(head/safe/finalized hash, attrs) -- drives
    the EL's head and optionally starts payload building.
  * get_payload(parent_hash, timestamp, prev_randao, fee_recipient) --
    the production path: fcU with attributes then engine_getPayload.

The port's copy of lighthouse_tpu/execution_layer/execution_layer.py.
"""

from __future__ import annotations

import enum

from ..resilience.primitives import RetryExhausted, RetryPolicy
from .engine_api import (
    EngineApiError,
    ForkchoiceState,
    PayloadAttributes,
    PayloadStatusV1Status,
)

# engine faults worth re-attempting: the API's own error shape plus
# transport errors (ConnectionError covers injected FaultPlan faults,
# TimeoutError/OSError cover sockets and injected hangs). EngineApiError
# is deliberately included even though it also covers semantic JSON-RPC
# rejections: the HTTP transport (http_engine.py/utils/jsonrpc.py)
# surfaces exhausted transport retries AS EngineApiError, and the
# reference treats an erroring engine like a syncing one (optimistic
# posture) rather than trusting it to distinguish its own failures.
TRANSIENT_ENGINE_ERRORS = (EngineApiError, ConnectionError, OSError)


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


class ExecutionLayer:
    def __init__(
        self,
        engine,
        suggested_fee_recipient: bytes = b"\x00" * 20,
        pre_merge_parent_hash: bytes | None = None,
        retry_policy: RetryPolicy | None = None,
        syncing_retry_attempts: int = 0,
    ):
        self.engine = engine
        self.suggested_fee_recipient = suggested_fee_recipient
        # resilience (opt-in, injected): with a RetryPolicy, transient
        # engine faults retry with backoff; an engine still unreachable
        # after the budget degrades newPayload to OPTIMISTIC (the
        # reference's optimistic-sync posture toward an offline engine)
        # while fcU/getPayload fail loudly. `syncing_retry_attempts`
        # additionally re-polls a SYNCING newPayload before settling for
        # the optimistic import.
        self.retry_policy = retry_policy
        self.syncing_retry_attempts = syncing_retry_attempts
        # the EL block to build the transition payload on before the merge
        # completes (terminal block seat); in-process mocks default to their
        # own genesis, remote engines must be told explicitly
        self.pre_merge_parent_hash = (
            pre_merge_parent_hash
            if pre_merge_parent_hash is not None
            else getattr(engine, "genesis_hash", None)
        )
        # per-proposer fee recipients pushed by VCs (reference
        # execution_layer proposer_preparation_data, fed by the VC's
        # preparation_service.rs prepare_beacon_proposer calls)
        self.proposer_preparations: dict[int, bytes] = {}

    def update_proposer_preparation(
        self, validator_index: int, fee_recipient: bytes
    ) -> None:
        self.proposer_preparations[validator_index] = bytes(fee_recipient)

    def fee_recipient_for(self, validator_index: int | None) -> bytes:
        if validator_index is None:
            return self.suggested_fee_recipient
        return self.proposer_preparations.get(
            validator_index, self.suggested_fee_recipient
        )

    def get_pow_block(self, block_hash: bytes):
        """(parent_hash, total_difficulty) of a pre-merge EL block, or
        None when the engine does not know it (still syncing) or has no
        pow surface (reference engines.rs get_pow_block via
        eth_getBlockByHash)."""
        getter = getattr(self.engine, "get_pow_block", None)
        if getter is None:
            return None
        return getter(block_hash)

    def validate_merge_block(self, payload_parent_hash: bytes, spec):
        """Spec validate_merge_block: the transition payload's parent pow
        block must cross the TTD while ITS parent is still under it.
        Returns True (valid), False (provably invalid), or None (pow data
        unavailable: import optimistically, re-check later -- the
        reference's otb_verification_service seat)."""
        if any(spec.terminal_block_hash):
            # terminal-block-hash override networks: the designated block
            # IS the terminal block; the TTD comparison is skipped
            return bytes(payload_parent_hash) == bytes(
                spec.terminal_block_hash
            )
        pow_block = self.get_pow_block(payload_parent_hash)
        if pow_block is None:
            return None
        parent_hash, ttd = pow_block
        if ttd < spec.terminal_total_difficulty:
            return False
        pow_parent = self.get_pow_block(parent_hash)
        if pow_parent is None:
            return None
        return pow_parent[1] < spec.terminal_total_difficulty

    def _engine_call(self, fn):
        """One engine round trip under the injected retry policy (none
        configured -> single attempt, errors propagate as before)."""
        if self.retry_policy is None:
            return fn()
        return self.retry_policy.call(fn, retry_on=TRANSIENT_ENGINE_ERRORS)

    # -- verification path (block import) -----------------------------------

    def notify_new_payload(self, payload) -> PayloadVerificationStatus:
        # the block-hash check runs LOCALLY before any engine round trip
        # (block_hash.rs via block_verification.rs): a payload whose header
        # doesn't keccak to its claimed hash is invalid no matter what a
        # (possibly lying) engine says, and never reaches the wire
        from .block_hash import verify_payload_block_hash

        try:
            verify_payload_block_hash(payload)
        except ValueError as e:
            raise PayloadInvalid(str(e)) from None
        syncing_budget = self.syncing_retry_attempts
        while True:
            try:
                status = self._engine_call(
                    lambda: self.engine.new_payload(payload)
                )
            except RetryExhausted:
                # the engine stayed unreachable through the retry budget:
                # treat it like a SYNCING engine and import optimistically
                # (payload_status.rs posture; fork choice re-checks later)
                return PayloadVerificationStatus.OPTIMISTIC
            s = status.status
            if s == PayloadStatusV1Status.VALID:
                return PayloadVerificationStatus.VERIFIED
            if s in (
                PayloadStatusV1Status.SYNCING,
                PayloadStatusV1Status.ACCEPTED,
            ):
                if s == PayloadStatusV1Status.SYNCING and syncing_budget > 0:
                    # re-poll a syncing engine before settling for the
                    # optimistic import -- it may catch up within the
                    # backoff window
                    syncing_budget -= 1
                    if self.retry_policy is not None:
                        self.retry_policy.pause(
                            self.syncing_retry_attempts - syncing_budget - 1
                        )
                    continue
                return PayloadVerificationStatus.OPTIMISTIC
            raise PayloadInvalid(
                f"execution payload invalid: {s.value}"
                + (
                    f" ({status.validation_error})"
                    if status.validation_error
                    else ""
                ),
                status.latest_valid_hash,
            )

    def notify_forkchoice_updated(
        self,
        head_block_hash: bytes,
        finalized_block_hash: bytes = b"\x00" * 32,
        safe_block_hash: bytes | None = None,
        attributes: PayloadAttributes | None = None,
    ):
        state = ForkchoiceState(
            head_block_hash=head_block_hash,
            safe_block_hash=(
                head_block_hash if safe_block_hash is None else safe_block_hash
            ),
            finalized_block_hash=finalized_block_hash,
        )
        resp = self._engine_call(
            lambda: self.engine.forkchoice_updated(state, attributes)
        )
        if resp.payload_status.status == PayloadStatusV1Status.INVALID:
            raise PayloadInvalid(
                "forkchoiceUpdated: head payload invalid",
                resp.payload_status.latest_valid_hash,
            )
        return resp

    # -- production path -----------------------------------------------------

    def build_payload_for_block(self, state, slot: int, proposer: int, preset, spec):
        """Execution payload for a block being produced on `state` at
        `slot` (the shared produce path of harness and BN block
        production): parent selection across the merge transition,
        spec-derived timestamp/randao, and the proposer's prepared fee
        recipient."""
        from ..state_transition.per_block import (
            compute_timestamp_at_slot,
            is_merge_transition_complete,
        )
        from ..types.helpers import get_randao_mix
        from ..types import compute_epoch_at_slot

        if is_merge_transition_complete(state):
            parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        else:
            # merge transition: build on the configured terminal EL block
            if self.pre_merge_parent_hash is None:
                raise EngineApiError(
                    "pre-merge payload requested with no terminal parent configured"
                )
            parent_hash = self.pre_merge_parent_hash
        epoch = compute_epoch_at_slot(slot, preset)
        return self.get_payload(
            parent_hash,
            compute_timestamp_at_slot(state, slot, spec),
            bytes(get_randao_mix(state, epoch, preset)),
            fee_recipient=self.fee_recipient_for(proposer),
        )

    def get_payload(
        self,
        parent_hash: bytes,
        timestamp: int,
        prev_randao: bytes,
        fee_recipient: bytes | None = None,
    ):
        attrs = PayloadAttributes(
            timestamp=timestamp,
            prev_randao=prev_randao,
            suggested_fee_recipient=(
                fee_recipient or self.suggested_fee_recipient
            ),
        )
        resp = self.notify_forkchoice_updated(
            parent_hash, attributes=attrs
        )
        if resp.payload_id is None:
            raise EngineApiError("engine did not start payload build")
        # block production must fail loudly: retries smooth transient
        # faults, but an exhausted budget propagates (no silent degrade)
        return self._engine_call(
            lambda: self.engine.get_payload(resp.payload_id)
        )
