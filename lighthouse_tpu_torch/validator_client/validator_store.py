"""ValidatorStore: the signing facade every duty service goes through
(reference validator_client/src/validator_store.rs + signing_method.rs +
initialized_validators.rs): key management, slashing-protection gating,
and doppelganger holds.

The port's copy of lighthouse_tpu/validator_client/validator_store.py.
"""

from __future__ import annotations

from ..crypto.bls.api import SecretKey, Signature
from ..ssz import uint64
from ..types import (
    compute_epoch_at_slot,
    compute_signing_root,
    get_domain,
)
from ..types.chain_spec import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
)
from ..types.containers import SigningData
from ..types.presets import Preset
from .slashing_protection import NotSafe, SlashingDatabase


class DoppelgangerHold(RuntimeError):
    """Signing refused: validator still in doppelganger observation."""


class LocalKeystore:
    """SigningMethod::LocalKeystore equivalent: in-memory secret key."""

    def __init__(self, secret_key: SecretKey):
        self.secret_key = secret_key
        self.pubkey = secret_key.public_key()

    def sign(self, signing_root: bytes) -> Signature:
        return self.secret_key.sign(signing_root)


class ValidatorStore:
    def __init__(
        self,
        preset: Preset,
        spec,
        slashing_db: SlashingDatabase | None = None,
    ):
        self.preset = preset
        self.spec = spec
        self.slashing_db = slashing_db or SlashingDatabase()
        self._methods: dict[bytes, LocalKeystore] = {}
        self._index_by_pubkey: dict[bytes, int] = {}
        self._doppelganger_hold: dict[bytes, bool] = {}
        # fee recipients (preparation_service.rs): per-validator override
        # over a process-wide default; None = not configured, and the
        # preparation service skips unconfigured validators (pushing a
        # zero address would burn fees and clobber the EL's own default)
        self.default_fee_recipient: bytes | None = None
        self._fee_recipients: dict[bytes, bytes] = {}

    # -- key management (initialized_validators.rs) -------------------------

    def add_validator(
        self,
        method: LocalKeystore,
        validator_index: int | None = None,
        doppelganger_protection: bool = False,
    ) -> None:
        pk = method.pubkey.to_bytes()
        self._methods[pk] = method
        if validator_index is not None:
            self._index_by_pubkey[pk] = validator_index
        self.slashing_db.register_validator(pk.hex())
        self._doppelganger_hold[pk] = doppelganger_protection

    def voting_pubkeys(self) -> list[bytes]:
        return list(self._methods.keys())

    def validator_index(self, pubkey: bytes) -> int | None:
        return self._index_by_pubkey.get(bytes(pubkey))

    def set_index(self, pubkey: bytes, index: int) -> None:
        self._index_by_pubkey[bytes(pubkey)] = index

    def release_doppelganger(self, pubkey: bytes) -> None:
        self._doppelganger_hold[bytes(pubkey)] = False

    def set_fee_recipient(self, pubkey: bytes, address: bytes) -> None:
        self._fee_recipients[bytes(pubkey)] = bytes(address)

    def fee_recipient_for(self, pubkey: bytes) -> bytes | None:
        return self._fee_recipients.get(
            bytes(pubkey), self.default_fee_recipient
        )

    def has_validator(self, pubkey: bytes) -> bool:
        return bytes(pubkey) in self._methods

    def signing_method(self, pubkey: bytes):
        return self._methods.get(bytes(pubkey))

    def remove_validator(self, pubkey: bytes) -> bool:
        """Drop a validator and all its per-key state (keymanager DELETE);
        returns False if unknown."""
        pk = bytes(pubkey)
        if pk not in self._methods:
            return False
        del self._methods[pk]
        self._index_by_pubkey.pop(pk, None)
        self._doppelganger_hold.pop(pk, None)
        self._fee_recipients.pop(pk, None)
        return True

    def _method(self, pubkey: bytes) -> LocalKeystore:
        m = self._methods.get(bytes(pubkey))
        if m is None:
            raise KeyError("unknown validator pubkey")
        if self._doppelganger_hold.get(bytes(pubkey)):
            raise DoppelgangerHold("validator held by doppelganger protection")
        return m

    # -- signing (validator_store.rs sign_*) --------------------------------

    def sign_validator_registration(
        self, pubkey: bytes, fee_recipient: bytes, gas_limit: int, timestamp: int
    ):
        """Builder-network registration (validator_store.rs
        sign_validator_registration): application-builder domain, no
        slashing-DB interaction (registrations are not consensus
        messages)."""
        from ..execution_layer.builder import builder_signing_root
        from ..types.containers import (
            SignedValidatorRegistration,
            ValidatorRegistrationV1,
        )

        method = self._method(pubkey)
        msg = ValidatorRegistrationV1(
            fee_recipient=bytes(fee_recipient),
            gas_limit=gas_limit,
            timestamp=timestamp,
            pubkey=bytes(pubkey),
        )
        sig = method.sign(builder_signing_root(msg, self.spec))
        return SignedValidatorRegistration(message=msg, signature=sig.to_bytes())

    def sign_block(self, pubkey: bytes, block, state) -> Signature:
        # resolve the method FIRST: a doppelganger hold must not burn the
        # slot in the slashing DB for a signature that is never produced
        method = self._method(pubkey)
        epoch = compute_epoch_at_slot(block.slot, self.preset)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch, self.preset)
        root = compute_signing_root(block, domain)
        self.slashing_db.check_and_insert_block_proposal(
            bytes(pubkey).hex(), block.slot, root
        )
        return method.sign(root)

    def sign_attestation(self, pubkey: bytes, data, state) -> Signature:
        method = self._method(pubkey)
        domain = get_domain(
            state, DOMAIN_BEACON_ATTESTER, data.target.epoch, self.preset
        )
        root = compute_signing_root(data, domain)
        self.slashing_db.check_and_insert_attestation(
            bytes(pubkey).hex(), data.source.epoch, data.target.epoch, root
        )
        return method.sign(root)

    def sign_randao(self, pubkey: bytes, epoch: int, state) -> Signature:
        domain = get_domain(state, DOMAIN_RANDAO, epoch, self.preset)
        root = SigningData(
            object_root=uint64.hash_tree_root(epoch), domain=domain
        ).tree_hash_root()
        return self._method(pubkey).sign(root)

    def sign_selection_proof(self, pubkey: bytes, slot: int, state) -> Signature:
        epoch = compute_epoch_at_slot(slot, self.preset)
        domain = get_domain(state, DOMAIN_SELECTION_PROOF, epoch, self.preset)
        root = SigningData(
            object_root=uint64.hash_tree_root(slot), domain=domain
        ).tree_hash_root()
        return self._method(pubkey).sign(root)

    def sign_aggregate_and_proof(self, pubkey: bytes, msg, state) -> Signature:
        epoch = compute_epoch_at_slot(msg.aggregate.data.slot, self.preset)
        domain = get_domain(
            state, DOMAIN_AGGREGATE_AND_PROOF, epoch, self.preset
        )
        root = compute_signing_root(msg, domain)
        return self._method(pubkey).sign(root)

    # -- sync committee (validator_store.rs sync-committee signing) ----------

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, beacon_block_root: bytes, state
    ) -> Signature:
        from ..types.chain_spec import DOMAIN_SYNC_COMMITTEE

        epoch = compute_epoch_at_slot(slot, self.preset)
        domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch, self.preset)
        root = SigningData(
            object_root=bytes(beacon_block_root), domain=domain
        ).tree_hash_root()
        return self._method(pubkey).sign(root)

    def sign_sync_selection_proof(
        self, pubkey: bytes, slot: int, subcommittee_index: int, state
    ) -> Signature:
        from ..types.chain_spec import DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF
        from ..types.containers import SyncAggregatorSelectionData

        epoch = compute_epoch_at_slot(slot, self.preset)
        domain = get_domain(
            state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch, self.preset
        )
        data = SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee_index
        )
        root = compute_signing_root(data, domain)
        return self._method(pubkey).sign(root)

    def sign_contribution_and_proof(self, pubkey: bytes, msg, state) -> Signature:
        from ..types.chain_spec import DOMAIN_CONTRIBUTION_AND_PROOF

        epoch = compute_epoch_at_slot(msg.contribution.slot, self.preset)
        domain = get_domain(
            state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch, self.preset
        )
        root = compute_signing_root(msg, domain)
        return self._method(pubkey).sign(root)
