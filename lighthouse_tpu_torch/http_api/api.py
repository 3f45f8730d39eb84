"""Standard Beacon API handlers (reference beacon_node/http_api/src/
lib.rs, 3476 lines of warp routes): transport-agnostic route functions
over the in-process node, JSON-shaped per the eth2 API spec (0x-hex
bytes, stringified integers). The HTTP adapter lives in server.py; the
typed client in client.py (reference common/eth2).

The port's copy of lighthouse_tpu/http_api/api.py.
"""

from __future__ import annotations

from ..state_transition import clone_state
from ..types import compute_epoch_at_slot, types_for
from ..validator_client.beacon_node import InProcessBeaconNode

API_VERSION = "lighthouse-tpu/0.1.0"


def hexs(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def unhex(s: str) -> bytes:
    return bytes.fromhex(s.removeprefix("0x"))


class ApiError(ValueError):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class BeaconApi:
    """Route handlers; names mirror the eth2 API paths."""

    def __init__(self, node: InProcessBeaconNode, network=None):
        self.node = node
        self.chain = node.chain
        # optional NetworkNode for the node/peers routes
        self.network = network
        # bounded (kind, payload) replay journal (debug view; the live
        # SSE path is the serving tier's broadcaster) — oldest events
        # age out with a drop counter instead of leaking memory
        from ..serving import EventRing

        self.events = EventRing(capacity=1024)
        self.chain.event_sinks.append(
            lambda kind, payload: self.events.append((kind, payload))
        )

    # -- state resolution ----------------------------------------------------

    def _state(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head_state
        if state_id == "genesis":
            root = chain.store.get_chain_item(
                b"block_post_state:" + chain.genesis_block_root
            )
            return chain.store.get_state(root)
        if state_id == "finalized":
            _, fin_root = chain.finalized_checkpoint
            st = chain._states.get(fin_root)
            if st is not None:
                return st
            return chain.head_state
        if state_id.startswith("0x"):
            return chain.store.get_state(unhex(state_id))
        raise ApiError(400, f"unsupported state id {state_id}")

    def _block_root(self, block_id: str) -> bytes:
        if block_id == "head":
            return self.chain.head_root
        if block_id == "genesis":
            return self.chain.genesis_block_root
        if block_id == "finalized":
            # serves URL-style checkpoint sync (builder.rs:206-340 fetches
            # the finalized block + state pair from a trusted node)
            return self.chain.finalized_checkpoint[1]
        if block_id.startswith("0x"):
            return unhex(block_id)
        raise ApiError(400, f"unsupported block id {block_id}")

    # -- beacon namespace ----------------------------------------------------

    def get_genesis(self) -> dict:
        state = self._state("genesis")
        return {
            "data": {
                "genesis_time": str(state.genesis_time),
                "genesis_validators_root": hexs(
                    state.genesis_validators_root
                ),
                "genesis_fork_version": hexs(
                    self.chain.spec.genesis_fork_version
                ),
            }
        }

    def get_state_root(self, state_id: str) -> dict:
        return {"data": {"root": hexs(self._state(state_id).tree_hash_root())}}

    def get_fork(self, state_id: str) -> dict:
        f = self._state(state_id).fork
        return {
            "data": {
                "previous_version": hexs(f.previous_version),
                "current_version": hexs(f.current_version),
                "epoch": str(f.epoch),
            }
        }

    def get_finality_checkpoints(self, state_id: str) -> dict:
        s = self._state(state_id)
        return {
            "data": {
                "previous_justified": {
                    "epoch": str(s.previous_justified_checkpoint.epoch),
                    "root": hexs(s.previous_justified_checkpoint.root),
                },
                "current_justified": {
                    "epoch": str(s.current_justified_checkpoint.epoch),
                    "root": hexs(s.current_justified_checkpoint.root),
                },
                "finalized": {
                    "epoch": str(s.finalized_checkpoint.epoch),
                    "root": hexs(s.finalized_checkpoint.root),
                },
            }
        }

    @staticmethod
    def _validator_entry(s, epoch: int, i: int) -> dict:
        v = s.validators[i]
        if v.activation_epoch > epoch:
            status = "pending"
        elif epoch < v.exit_epoch:
            status = "active_ongoing"
        else:
            status = "exited"
        return {
            "index": str(i),
            "balance": str(s.balances[i]),
            "status": status,
            "validator": {
                "pubkey": hexs(v.pubkey),
                "effective_balance": str(v.effective_balance),
                "slashed": bool(v.slashed),
                "activation_epoch": str(v.activation_epoch),
                "exit_epoch": str(v.exit_epoch),
            },
        }

    def get_validators(self, state_id: str) -> dict:
        s = self._state(state_id)
        epoch = compute_epoch_at_slot(s.slot, self.chain.preset)
        return {
            "data": [
                self._validator_entry(s, epoch, i)
                for i in range(len(s.validators))
            ]
        }

    def get_block(self, block_id: str) -> dict:
        root = self._block_root(block_id)
        blk = self.chain.store.get_block_any_temperature(root)
        if blk is None:
            raise ApiError(404, "block not found")
        return {
            "version": type(blk).fork_name,
            "data": {"ssz": hexs(blk.as_ssz_bytes())},
        }

    def get_block_header(self, block_id: str) -> dict:
        root = self._block_root(block_id)
        blk = self.chain.store.get_block_any_temperature(root)
        if blk is None:
            raise ApiError(404, "block not found")
        m = blk.message
        return {
            "data": {
                "root": hexs(root),
                "header": {
                    "slot": str(m.slot),
                    "proposer_index": str(m.proposer_index),
                    "parent_root": hexs(m.parent_root),
                    "state_root": hexs(m.state_root),
                    "body_root": hexs(m.body.tree_hash_root()),
                },
            }
        }

    def post_block(self, ssz_hex: str, fork: str) -> dict:
        from ..types import block_classes_for

        t = types_for(self.chain.preset)
        _, signed_cls, _ = block_classes_for(t, fork)
        blk = signed_cls.from_ssz_bytes(unhex(ssz_hex))
        root = self.node.publish_block(blk)
        return {"data": {"root": hexs(root)}}

    def post_pool_attestations(self, attestations_ssz: list[str]) -> dict:
        t = types_for(self.chain.preset)
        for ssz_hex in attestations_ssz:
            att = t.Attestation.from_ssz_bytes(unhex(ssz_hex))
            self.node.publish_attestation(att)
        return {}

    # -- validator namespace -------------------------------------------------

    def get_proposer_duties(self, epoch: int) -> dict:
        duties = self.node.get_proposer_duties(epoch)
        state = self.chain.head_state
        return {
            "data": [
                {
                    "pubkey": hexs(state.validators[v].pubkey),
                    "validator_index": str(v),
                    "slot": str(slot),
                }
                for slot, v in duties
            ]
        }

    def post_attester_duties(self, epoch: int, indices: list[int]) -> dict:
        duties = self.node.get_attester_duties(epoch, indices)
        state = self.chain.head_state
        return {
            "data": [
                {
                    "pubkey": hexs(
                        state.validators[d["validator_index"]].pubkey
                    ),
                    "validator_index": str(d["validator_index"]),
                    "slot": str(d["slot"]),
                    "committee_index": str(d["committee_index"]),
                    "committee_length": str(d["committee_length"]),
                    "validator_committee_index": str(
                        d["committee_position"]
                    ),
                    "committees_at_slot": str(d["committees_at_slot"]),
                }
                for d in duties
            ]
        }

    def produce_block(
        self, slot: int, randao_reveal: str, graffiti: str | None = None
    ) -> dict:
        block = self.node.produce_block(
            slot,
            unhex(randao_reveal),
            graffiti=unhex(graffiti) if graffiti else b"",
        )
        return {
            "version": type(block).fork_name,
            "data": {"ssz": hexs(block.as_ssz_bytes())},
        }

    def attestation_data(self, slot: int, committee_index: int) -> dict:
        data = self.node.produce_attestation_data(slot, committee_index)
        return {"data": {"ssz": hexs(data.as_ssz_bytes())}}

    def aggregate_attestation(self, data_ssz: str) -> dict:
        from ..types.containers import AttestationData

        data = AttestationData.from_ssz_bytes(unhex(data_ssz))
        agg = self.node.get_aggregate(data)
        if agg is None:
            raise ApiError(404, "no matching aggregate")
        return {"data": {"ssz": hexs(agg.as_ssz_bytes())}}

    def post_aggregate_and_proofs(self, items_ssz: list[str]) -> dict:
        t = types_for(self.chain.preset)
        for ssz_hex in items_ssz:
            self.node.publish_aggregate_and_proof(
                t.SignedAggregateAndProof.from_ssz_bytes(unhex(ssz_hex))
            )
        return {}

    def prepare_beacon_proposer(self, preparations: list[dict]) -> dict:
        """POST /eth/v1/validator/prepare_beacon_proposer: fee recipients
        per proposer for payload builds (preparation_service.rs feed)."""
        self.node.prepare_proposers(
            [
                {
                    "validator_index": int(p["validator_index"]),
                    "fee_recipient": unhex(p["fee_recipient"]),
                }
                for p in preparations
            ]
        )
        return {}

    def get_validator(self, state_id: str, validator_id: str) -> dict:
        """/eth/v1/beacon/states/{id}/validators/{validator_id}: by index
        or 0x pubkey; only the requested entry is built."""
        s = self._state(state_id)
        if validator_id.startswith("0x"):
            pk = unhex(validator_id)
            matches = [
                i for i, v in enumerate(s.validators) if bytes(v.pubkey) == pk
            ]
            if not matches:
                raise ApiError(404, "validator not found")
            index = matches[0]
        else:
            if not validator_id.isdigit():  # rejects negatives + garbage
                raise ApiError(400, f"bad validator id {validator_id!r}")
            index = int(validator_id)
            if index >= len(s.validators):
                raise ApiError(404, "validator not found")
        epoch = compute_epoch_at_slot(s.slot, self.chain.preset)
        return {"data": self._validator_entry(s, epoch, index)}

    def get_validator_balances(self, state_id: str) -> dict:
        s = self._state(state_id)
        return {
            "data": [
                {"index": str(i), "balance": str(b)}
                for i, b in enumerate(s.balances)
            ]
        }

    def get_committees(self, state_id: str, epoch: int | None = None) -> dict:
        from ..state_transition.context import ConsensusContext

        s = self._state(state_id)
        preset = self.chain.preset
        if epoch is None:
            epoch = compute_epoch_at_slot(s.slot, preset)
        ctxt = ConsensusContext(preset, self.chain.spec)
        cache = ctxt.committee_cache(s, epoch)
        start = epoch * preset.slots_per_epoch
        out = []
        for slot in range(start, start + preset.slots_per_epoch):
            for index in range(cache.committees_per_slot):
                out.append(
                    {
                        "index": str(index),
                        "slot": str(slot),
                        "validators": [
                            str(v)
                            for v in cache.get_beacon_committee(slot, index)
                        ],
                    }
                )
        return {"data": out}

    def get_sync_committees(self, state_id: str) -> dict:
        s = self._state(state_id)
        if not hasattr(s, "current_sync_committee"):
            raise ApiError(400, "state predates altair")
        pk_to_idx = {
            bytes(v.pubkey): i for i, v in enumerate(s.validators)
        }
        indices = [
            str(pk_to_idx.get(bytes(pk), 0))
            for pk in s.current_sync_committee.pubkeys
        ]
        return {"data": {"validators": indices}}

    def get_block_root(self, block_id: str) -> dict:
        root = self._block_root(block_id)
        if self.chain.store.get_block_any_temperature(root) is None:
            raise ApiError(404, "block not found")
        return {"data": {"root": hexs(root)}}

    def get_block_attestations(self, block_id: str) -> dict:
        root = self._block_root(block_id)
        blk = self.chain.store.get_block_any_temperature(root)
        if blk is None:
            raise ApiError(404, "block not found")
        return {
            "data": [
                {"ssz": hexs(a.as_ssz_bytes())}
                for a in blk.message.body.attestations
            ]
        }

    # -- pool routes (exits / slashings / sync messages) ---------------------

    def get_pool_voluntary_exits(self) -> dict:
        return {
            "data": [
                {"ssz": hexs(e.as_ssz_bytes())}
                for e in self.node.op_pool._voluntary_exits.values()
            ]
        }

    def get_pool_proposer_slashings(self) -> dict:
        return {
            "data": [
                {"ssz": hexs(s.as_ssz_bytes())}
                for s in self.node.op_pool._proposer_slashings.values()
            ]
        }

    def get_pool_attester_slashings(self) -> dict:
        return {
            "data": [
                {"ssz": hexs(s.as_ssz_bytes())}
                for s in self.node.op_pool._attester_slashings
            ]
        }

    def post_pool_voluntary_exits(self, ssz_hex: str) -> dict:
        from ..types.containers import SignedVoluntaryExit

        exit_op = SignedVoluntaryExit.from_ssz_bytes(unhex(ssz_hex))
        publish = getattr(self.network, "publish_voluntary_exit", None)
        if publish is not None:
            publish(exit_op)
        else:
            self.node.op_pool.insert_voluntary_exit(exit_op)
        return {}

    def post_pool_sync_committees(self, messages: list[dict]) -> dict:
        from ..types.containers import SyncCommitteeMessage

        for m in messages:
            msg = SyncCommitteeMessage.from_ssz_bytes(unhex(m["ssz"]))
            self.node.publish_sync_message(msg, int(m.get("subnet", 0)))
        return {}

    # -- sync-committee validator routes -------------------------------------

    def post_sync_duties(self, epoch: int, indices: list[int]) -> dict:
        duties = self.node.get_sync_duties(epoch, indices)
        state = self.chain.head_state
        size = (
            self.chain.preset.sync_committee_size
            // self.chain.preset.sync_committee_subnet_count
        )
        out = []
        for d in duties:
            # wire shape: positions within the FULL committee
            # (validator_sync_committee_indices, per the eth2 API spec);
            # in-process shape: {subnet: positions-in-subcommittee}
            committee_positions = [
                subnet * size + pos
                for subnet, positions in d["subnets"].items()
                for pos in positions
            ]
            out.append(
                {
                    "pubkey": hexs(
                        state.validators[d["validator_index"]].pubkey
                    ),
                    "validator_index": str(d["validator_index"]),
                    "validator_sync_committee_indices": [
                        str(i) for i in committee_positions
                    ],
                }
            )
        return {"data": out}

    def sync_committee_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: str
    ) -> dict:
        contribution = self.node.get_sync_contribution(
            slot, unhex(beacon_block_root), subcommittee_index
        )
        if contribution is None:
            raise ApiError(404, "no matching contribution")
        return {"data": {"ssz": hexs(contribution.as_ssz_bytes())}}

    def post_contribution_and_proofs(self, items_ssz: list[str]) -> dict:
        from ..types import types_for as _tf

        t = _tf(self.chain.preset)
        for ssz_hex in items_ssz:
            self.node.publish_contribution_and_proof(
                t.SignedContributionAndProof.from_ssz_bytes(unhex(ssz_hex))
            )
        return {}

    # -- builder routes -------------------------------------------------------

    def register_validator(self, registrations_ssz: list[str]) -> dict:
        """POST /eth/v1/validator/register_validator: forward signed
        builder registrations (builder fan-out seat)."""
        from ..types.containers import SignedValidatorRegistration

        regs = [
            SignedValidatorRegistration.from_ssz_bytes(unhex(r))
            for r in registrations_ssz
        ]
        self.node.register_validators(regs)
        return {}

    def produce_blinded_block(self, slot: int, randao_reveal: str) -> dict:
        block = self.node.produce_blinded_block(slot, unhex(randao_reveal))
        return {
            "version": "bellatrix",
            "data": {"ssz": hexs(block.as_ssz_bytes())},
        }

    def post_blinded_block(self, ssz_hex: str) -> dict:
        t = types_for(self.chain.preset)
        signed = t.SignedBlindedBeaconBlock.from_ssz_bytes(unhex(ssz_hex))
        root = self.node.publish_blinded_block(signed)
        return {"data": {"root": hexs(root)}}

    # -- light client (beacon/light_client routes + the RPC protocol's
    #    data source; reference light_client_bootstrap.rs + http_api) -------

    def get_light_client_bootstrap(self, block_root_hex: str) -> dict:
        from ..chain.light_client import (
            LightClientError,
            light_client_bootstrap,
        )

        root = unhex(block_root_hex)
        state = self.chain.state_for_block_root(root)
        if state is None:
            raise ApiError(404, "unknown block root")
        try:
            b = light_client_bootstrap(state, self.chain.preset)
        except LightClientError as e:
            raise ApiError(400, str(e)) from None
        return {"data": {"ssz": hexs(b.as_ssz_bytes())}}

    def _attested_context(self):
        """(attested_state, sync_aggregate, signature_slot) derived from
        the head block: its sync aggregate attests its parent."""
        head_block = self.chain.store.get_block_any_temperature(
            self.chain.head_root
        )
        if head_block is None:
            raise ApiError(404, "no head block")
        body = head_block.message.body
        agg = getattr(body, "sync_aggregate", None)
        if agg is None:
            raise ApiError(404, "head predates altair")
        attested = self.chain._states.get(bytes(head_block.message.parent_root))
        if attested is None:
            raise ApiError(404, "attested state unavailable")
        return attested, agg, int(head_block.message.slot)

    def get_light_client_finality_update(self) -> dict:
        from ..chain.light_client import light_client_finality_update

        attested, agg, slot = self._attested_context()
        fin_root = bytes(attested.finalized_checkpoint.root)
        fin_block = (
            self.chain.store.get_block_any_temperature(fin_root)
            if any(fin_root)
            else None
        )
        if fin_block is None:
            raise ApiError(404, "no finalized block yet")
        from ..types.containers import header_from_block

        fin_header = header_from_block(fin_block.message)
        u = light_client_finality_update(
            attested, fin_header, agg, slot, self.chain.preset
        )
        return {"data": {"ssz": hexs(u.as_ssz_bytes())}}

    def get_light_client_optimistic_update(self) -> dict:
        from ..chain.light_client import light_client_optimistic_update

        attested, agg, slot = self._attested_context()
        u = light_client_optimistic_update(
            attested, agg, slot, self.chain.preset
        )
        return {"data": {"ssz": hexs(u.as_ssz_bytes())}}

    # -- config namespace -----------------------------------------------------

    def get_spec(self) -> dict:
        """/eth/v1/config/spec: the runtime chain configuration."""
        spec = self.chain.spec
        preset = self.chain.preset
        out = {
            "CONFIG_NAME": spec.config_name,
            "GENESIS_FORK_VERSION": hexs(spec.genesis_fork_version),
            "ALTAIR_FORK_VERSION": hexs(spec.altair_fork_version),
            "BELLATRIX_FORK_VERSION": hexs(spec.bellatrix_fork_version),
            "SECONDS_PER_SLOT": str(spec.seconds_per_slot),
            "SLOTS_PER_EPOCH": str(preset.slots_per_epoch),
            "MAX_VALIDATORS_PER_COMMITTEE": str(
                preset.max_validators_per_committee
            ),
            "MAX_COMMITTEES_PER_SLOT": str(preset.max_committees_per_slot),
            "MAX_EFFECTIVE_BALANCE": str(spec.max_effective_balance),
            "SHARD_COMMITTEE_PERIOD": str(spec.shard_committee_period),
            "PROPOSER_SCORE_BOOST": str(spec.proposer_score_boost),
        }
        if spec.altair_fork_epoch is not None:
            out["ALTAIR_FORK_EPOCH"] = str(spec.altair_fork_epoch)
        if spec.bellatrix_fork_epoch is not None:
            out["BELLATRIX_FORK_EPOCH"] = str(spec.bellatrix_fork_epoch)
        return {"data": out}

    def get_fork_schedule(self) -> dict:
        spec = self.chain.spec
        forks = [
            {
                "previous_version": hexs(spec.genesis_fork_version),
                "current_version": hexs(spec.genesis_fork_version),
                "epoch": "0",
            }
        ]
        if spec.altair_fork_epoch is not None:
            forks.append(
                {
                    "previous_version": hexs(spec.genesis_fork_version),
                    "current_version": hexs(spec.altair_fork_version),
                    "epoch": str(spec.altair_fork_epoch),
                }
            )
        if spec.bellatrix_fork_epoch is not None:
            forks.append(
                {
                    "previous_version": hexs(spec.altair_fork_version),
                    "current_version": hexs(spec.bellatrix_fork_version),
                    "epoch": str(spec.bellatrix_fork_epoch),
                }
            )
        return {"data": forks}

    def get_deposit_contract(self) -> dict:
        from ..eth1.jsonrpc import DEPOSIT_CONTRACT_ADDRESS

        return {
            "data": {
                "chain_id": "1",
                "address": DEPOSIT_CONTRACT_ADDRESS,
            }
        }

    # -- debug namespace ------------------------------------------------------

    def get_debug_state(self, state_id: str) -> dict:
        """/eth/v2/debug/beacon/states/{id}: the full SSZ state."""
        s = self._state(state_id)
        return {
            "version": s.fork_name,
            "data": {"ssz": hexs(s.as_ssz_bytes())},
        }

    def get_debug_heads(self) -> dict:
        pa = self.chain.fork_choice.proto.proto_array
        children = {n.parent for n in pa.nodes if n.parent is not None}
        return {
            "data": [
                {"root": hexs(n.root), "slot": str(n.slot)}
                for i, n in enumerate(pa.nodes)
                if i not in children
            ]
        }

    # -- node namespace ------------------------------------------------------

    def get_identity(self) -> dict:
        peer_id = getattr(self.network, "peer_id", "in-process")
        return {"data": {"peer_id": peer_id, "metadata": {}}}

    def get_peers(self) -> dict:
        if self.network is None:
            return {"data": [], "meta": {"count": 0}}
        peers = []
        for pid, score in self.network.peer_scores.items():
            peers.append(
                {
                    "peer_id": pid,
                    "state": (
                        "disconnected"
                        if self.network.is_banned(pid)
                        else "connected"
                    ),
                    "score": str(score),
                }
            )
        # bus-known peers without recorded scores
        bus_peers = getattr(self.network.bus, "_peers", {})
        for pid in bus_peers:
            if pid not in self.network.peer_scores:
                peers.append(
                    {"peer_id": pid, "state": "connected", "score": "0"}
                )
        return {"data": peers, "meta": {"count": len(peers)}}

    def get_peer(self, peer_id: str) -> dict:
        for p in self.get_peers()["data"]:
            if p["peer_id"] == peer_id:
                return {"data": p}
        raise ApiError(404, "peer not found")

    def get_peer_count(self) -> dict:
        peers = self.get_peers()["data"]
        connected = sum(1 for p in peers if p["state"] == "connected")
        return {
            "data": {
                "connected": str(connected),
                "disconnected": str(len(peers) - connected),
                "connecting": "0",
                "disconnecting": "0",
            }
        }

    def get_health(self) -> int:
        return 200 if self.node.is_healthy() else 503

    def get_state_randao(self, state_id: str, epoch: int | None = None) -> dict:
        """GET /eth/v1/beacon/states/{id}/randao. Epochs outside the
        state's randao history window are a 400, not a silently wrapped
        stale mix."""
        from ..types.helpers import get_randao_mix

        state = self._state(state_id)
        current = state.slot // self.chain.preset.slots_per_epoch
        target = epoch if epoch is not None else current
        window = self.chain.preset.epochs_per_historical_vector
        if target < 0 or target > current or current - target >= window:
            raise ApiError(400, "epoch outside the randao history window")
        mix = get_randao_mix(state, target, self.chain.preset)
        return {"data": {"randao": hexs(mix)}}

    def get_headers(self, slot: int | None = None) -> dict:
        """GET /eth/v1/beacon/headers (canonical head, or by slot; a
        SKIPPED slot returns an empty list, per the Beacon API)."""
        from ..types.containers import header_from_block

        if slot is None:
            root = self.chain.head_root
            signed = self.chain.store.get_block_any_temperature(root)
            pairs = [(root, signed)] if signed is not None else []
        else:
            head_slot = int(self.chain.head_state.slot)
            if slot > head_slot:
                pairs = []
            elif head_slot - slot > 256:
                # distinguish "beyond the bounded walk" from "skipped
                # slot": an empty list here would misreport real blocks
                raise ApiError(
                    400, "slot more than 256 behind head (walk bound)"
                )
            else:
                # exact-slot match only: the parent walk never invents a
                # block for an empty slot (block_roots back-fill would)
                pairs = [
                    (root, blk)
                    for root, blk in self._canonical_blocks_in_range(
                        slot, slot
                    )
                    if blk.message.slot == slot
                ]
        out = []
        for root, signed in pairs:
            hdr = header_from_block(signed.message)
            out.append(
                {
                    "root": hexs(root),
                    "canonical": True,
                    "header": {
                        "message": {
                            "slot": str(hdr.slot),
                            "proposer_index": str(hdr.proposer_index),
                            "parent_root": hexs(hdr.parent_root),
                            "state_root": hexs(hdr.state_root),
                            "body_root": hexs(hdr.body_root),
                        },
                        "signature": hexs(signed.signature),
                    },
                }
            )
        return {"data": out}

    def subscribe_beacon_committee(self, subscriptions: list) -> dict:
        """POST /eth/v1/validator/beacon_committee_subscriptions: forward
        duty subnet subscriptions to the attestation subnet service."""
        svc = (
            getattr(self.network, "subnet_service", None)
            if self.network
            else None
        )
        if svc is not None:
            for sub in subscriptions:
                svc.subscribe_for_duty(
                    int(sub["slot"]),
                    int(sub["committees_at_slot"]),
                    int(sub["committee_index"]),
                )
        return {"data": None}

    def subscribe_sync_committee(self, subscriptions: list) -> dict:
        """POST /eth/v1/validator/sync_committee_subscriptions (accepted;
        sync subnets are always-on in this node)."""
        return {"data": None}

    # -- /lighthouse/* extensions (reference http_api's lighthouse
    #    namespace: validator-inclusion, block-packing-efficiency,
    #    database, proto-array, UI endpoints) ------------------------------

    def lighthouse_validator_inclusion(self, epoch: int) -> dict:
        """Global participation for an epoch (validator_inclusion.rs):
        active gwei vs the target/head-attesting gwei of the previous
        epoch, from the head state's participation flags (altair) or
        pending attestations (phase0)."""
        from ..state_transition.participation import (
            TIMELY_HEAD_FLAG_INDEX,
            TIMELY_TARGET_FLAG_INDEX,
            has_flag,
        )
        from ..types import is_active_validator

        s = self.chain.head_state
        head_epoch = compute_epoch_at_slot(s.slot, self.chain.preset)
        # the head state only holds participation for ITS previous epoch;
        # other epochs would silently return head-relative numbers under
        # the requested label
        if epoch != max(head_epoch - 1, 0):
            raise ApiError(
                400,
                f"inclusion data only available for epoch {max(head_epoch - 1, 0)}",
            )
        active_gwei = sum(
            v.effective_balance
            for v in s.validators
            if is_active_validator(v, epoch)
        )
        target_gwei = 0
        head_gwei = 0
        if hasattr(s, "previous_epoch_participation"):
            part = s.previous_epoch_participation
            for i, flags in enumerate(part):
                v = s.validators[i]
                if v.slashed or not is_active_validator(v, epoch):
                    continue
                if has_flag(flags, TIMELY_TARGET_FLAG_INDEX):
                    target_gwei += v.effective_balance
                if has_flag(flags, TIMELY_HEAD_FLAG_INDEX):
                    head_gwei += v.effective_balance
        else:
            # phase0: real attester sets from the pending attestations
            from ..state_transition.per_epoch import (
                _attesting_indices,
                _matching_head_attestations,
                _matching_target_attestations,
            )

            cache_map: dict = {}
            prev = max(epoch, 0)
            target_idx = _attesting_indices(
                s,
                _matching_target_attestations(s, prev, self.chain.preset),
                self.chain.preset,
                self.chain.spec,
                cache_map,
            )
            head_idx = _attesting_indices(
                s,
                _matching_head_attestations(s, prev, self.chain.preset),
                self.chain.preset,
                self.chain.spec,
                cache_map,
            )
            target_gwei = sum(
                s.validators[i].effective_balance for i in target_idx
            )
            head_gwei = sum(
                s.validators[i].effective_balance for i in head_idx
            )
        return {
            "data": {
                "current_epoch_active_gwei": str(active_gwei),
                "previous_epoch_target_attesting_gwei": str(target_gwei),
                "previous_epoch_head_attesting_gwei": str(head_gwei),
            }
        }

    def lighthouse_validator_inclusion_validator(
        self, epoch: int, validator_id: str
    ) -> dict:
        """Single-validator inclusion for an epoch
        (validator_inclusion.rs validator_inclusion_data): slashed /
        withdrawable / active status plus per-flag attestation hits from
        the participation bits."""
        from ..state_transition.participation import (
            TIMELY_HEAD_FLAG_INDEX,
            TIMELY_SOURCE_FLAG_INDEX,
            TIMELY_TARGET_FLAG_INDEX,
            has_flag,
        )
        from ..types import is_active_validator

        s = self.chain.head_state
        head_epoch = compute_epoch_at_slot(s.slot, self.chain.preset)
        if epoch != max(head_epoch - 1, 0):
            raise ApiError(
                400,
                f"inclusion data only available for epoch {max(head_epoch - 1, 0)}",
            )
        if validator_id.startswith("0x"):
            pubkey = unhex(validator_id)
            index = next(
                (
                    i
                    for i, v in enumerate(s.validators)
                    if bytes(v.pubkey) == pubkey
                ),
                None,
            )
        else:
            if not validator_id.isdigit():  # rejects negatives + garbage
                raise ApiError(400, f"bad validator id {validator_id!r}")
            index = int(validator_id)
        if index is None or index >= len(s.validators):
            raise ApiError(404, f"unknown validator {validator_id}")
        v = s.validators[index]
        flags = (
            s.previous_epoch_participation[index]
            if hasattr(s, "previous_epoch_participation")
            else 0
        )
        active = is_active_validator(v, epoch)
        return {
            "data": {
                "is_slashed": bool(v.slashed),
                "is_withdrawable_in_current_epoch": (
                    epoch >= v.withdrawable_epoch
                ),
                "is_active_unslashed_in_previous_epoch": (
                    active and not v.slashed
                ),
                "current_epoch_effective_balance_gwei": str(
                    v.effective_balance
                ),
                "is_previous_epoch_source_attester": bool(
                    has_flag(flags, TIMELY_SOURCE_FLAG_INDEX)
                ),
                "is_previous_epoch_target_attester": bool(
                    has_flag(flags, TIMELY_TARGET_FLAG_INDEX)
                ),
                "is_previous_epoch_head_attester": bool(
                    has_flag(flags, TIMELY_HEAD_FLAG_INDEX)
                ),
            }
        }

    def _state_at_slot(self, slot: int):
        """Historical state resolution: authoritative cold path below the
        split; above it, the CANONICAL state root from the head state's
        ring buffer (forwards_state_roots_iter) — never the
        last-writer-wins state_at_slot chain index, which can name a
        non-canonical fork's state (hot_cold.py documents exactly that
        hazard for the restore-point path)."""
        from ..store.hot_cold import StoreError

        store = self.chain.store
        if slot < store.split_slot:
            try:
                return store.load_cold_state(slot)
            except KeyError:  # StoreError subclasses KeyError
                # unreconstructable cold slot (no restore point below, or
                # a documented state-root gap): this epoch is unavailable,
                # not the whole response
                return None
        head_state = self.chain.head_state
        if slot > int(head_state.slot):
            return None
        try:
            root, _ = next(
                iter(store.forwards_state_roots_iter(slot, slot, head_state))
            )
        except (StoreError, StopIteration):
            return None  # outside the hot ring: unavailable, not fatal
        try:
            return store.get_state(root)
        except KeyError:
            return None

    def lighthouse_attestation_performance(
        self, index: int, start_epoch: int, end_epoch: int
    ) -> dict:
        """Per-epoch attestation performance for one validator across a
        historical range (attestation_performance.rs): epoch E's
        participation flags live in the previous_epoch_participation of
        the state at the first slot of E+1."""
        from ..state_transition.participation import (
            TIMELY_HEAD_FLAG_INDEX,
            TIMELY_SOURCE_FLAG_INDEX,
            TIMELY_TARGET_FLAG_INDEX,
            has_flag,
        )
        from ..types import is_active_validator

        if end_epoch < start_epoch or end_epoch - start_epoch > 32:
            raise ApiError(400, "bad epoch range (max 32 epochs)")
        spe = self.chain.preset.slots_per_epoch
        epochs = []
        for epoch in range(start_epoch, end_epoch + 1):
            state = self._state_at_slot((epoch + 1) * spe)
            if state is None or not hasattr(
                state, "previous_epoch_participation"
            ):
                epochs.append({"epoch": str(epoch), "available": False})
                continue
            if index >= len(state.validators):
                epochs.append({"epoch": str(epoch), "available": False})
                continue
            v = state.validators[index]
            flags = state.previous_epoch_participation[index]
            epochs.append(
                {
                    "epoch": str(epoch),
                    "available": True,
                    "active": is_active_validator(v, epoch),
                    "source": bool(has_flag(flags, TIMELY_SOURCE_FLAG_INDEX)),
                    "target": bool(has_flag(flags, TIMELY_TARGET_FLAG_INDEX)),
                    "head": bool(has_flag(flags, TIMELY_HEAD_FLAG_INDEX)),
                }
            )
        return {"data": {"index": str(index), "epochs": epochs}}

    def lighthouse_validator_metrics(self, indices: list[int]) -> dict:
        """POST /lighthouse/ui/validator_metrics (http_api lib.rs:2902):
        per-validator monitor stats incl. epoch summaries."""
        monitor = self.chain.validator_monitor
        if monitor is None:
            raise ApiError(400, "validator monitor not enabled")
        out = {}
        for i in indices:
            try:
                idx = int(i)
            except (TypeError, ValueError):
                raise ApiError(400, f"bad validator index {i!r}") from None
            s = monitor.stats(idx)
            if s is not None:
                out[str(idx)] = s
        return {"data": {"validators": out}}

    def lighthouse_health(self) -> dict:
        """GET /lighthouse/health (lib.rs:2855): process liveness basics,
        from the ONE getrusage reader (utils/monitoring.process_metrics)."""
        from ..utils.monitoring import process_metrics

        data = {k: str(v) for k, v in process_metrics().items()}
        data["head_slot"] = str(self.chain.head_state.slot)
        return {"data": data}

    def lighthouse_syncing(self) -> dict:
        """GET /lighthouse/syncing (lib.rs:2918): the node's sync state
        with the lighthouse-native shape."""
        body = self.get_syncing()["data"]
        state = (
            "Synced" if not body.get("is_syncing") else "SyncingFinalized"
        )
        return {"data": state}

    def lighthouse_staking(self) -> dict:
        """GET /lighthouse/staking (lib.rs:3127): 200 iff the node can
        support staking (an eth1/deposit source is wired)."""
        if self.node.eth1_service is None:
            raise ApiError(
                404, "staking unavailable: no eth1 endpoint configured"
            )
        return {"data": "staking ready"}

    def lighthouse_eth1_syncing(self) -> dict:
        """GET /lighthouse/eth1/syncing (lib.rs:3033)."""
        svc = self.node.eth1_service
        if svc is None:
            raise ApiError(400, "no eth1 service")
        head = svc.block_cache[-1] if svc.block_cache else None
        return {
            "data": {
                "head_block_number": str(head.number) if head else None,
                "head_block_timestamp": str(head.timestamp) if head else None,
                # the service does not track the remote head, so the sync
                # percentage is honestly UNKNOWN — never a fabricated 100
                "eth1_node_sync_status_percentage": None,
                "lighthouse_is_cached_and_ready": bool(head),
            }
        }

    def lighthouse_eth1_block_cache(self) -> dict:
        """GET /lighthouse/eth1/block_cache (lib.rs:3063)."""
        svc = self.node.eth1_service
        if svc is None:
            raise ApiError(400, "no eth1 service")
        return {
            "data": [
                {
                    "number": str(b.number),
                    "hash": hexs(b.hash),
                    "timestamp": str(b.timestamp),
                    "deposit_count": str(b.deposit_count),
                }
                for b in svc.block_cache
            ]
        }

    def lighthouse_eth1_deposit_cache(self) -> dict:
        """GET /lighthouse/eth1/deposit_cache (lib.rs:3082)."""
        svc = self.node.eth1_service
        if svc is None:
            raise ApiError(400, "no eth1 service")
        return {
            "data": [
                {
                    "pubkey": hexs(d.pubkey),
                    "amount": str(d.amount),
                }
                for d in svc._deposit_data
            ]
        }

    def lighthouse_merge_readiness(self) -> dict:
        """GET /lighthouse/merge_readiness (lib.rs:3240)."""
        el = self.chain.execution_layer
        if el is None:
            return {
                "data": {
                    "type": "not_ready",
                    "reason": "no execution endpoint configured",
                }
            }
        return {"data": {"type": "ready"}}

    def lighthouse_database_reconstruct(self) -> dict:
        """POST /lighthouse/database/reconstruct (lib.rs:3155): fill any
        missing restore-point states below the split from the chunked
        columns (the reference's historic state reconstruction trigger).
        The store owns the bounded per-stride batch sweep and its marker
        semantics (HotColdDB.reconstruct_historic_states)."""
        added = self.chain.store.reconstruct_historic_states()
        return {
            "data": f"reconstruction complete: +{added} restore points"
        }

    def lighthouse_liveness(self, indices: list, epoch: int) -> dict:
        """POST /lighthouse/liveness (lib.rs:2812): did these validators
        show signs of life (gossip attestations seen) in `epoch`? Served
        from the validator monitor's observation stream."""
        monitor = self.chain.validator_monitor
        spe = self.chain.preset.slots_per_epoch
        out = []
        for i in indices:
            try:
                idx = int(i)
            except (TypeError, ValueError):
                raise ApiError(400, f"bad validator index {i!r}") from None
            live = False
            if monitor is not None:
                v = monitor.validators.get(idx)
                if v is not None:
                    lo, hi = epoch * spe, (epoch + 1) * spe
                    # live = seen on gossip OR included on-chain in `epoch`
                    # (recent_attestation_slots keeps a WINDOW of gossip
                    # slots; a newer attestation must not erase epoch E)
                    live = any(
                        lo <= sl < hi for sl in v.recent_attestation_slots
                    ) or any(
                        lo <= sl < hi
                        for sl in v.attestation_min_delay_slots
                    )
            out.append(
                {"index": str(idx), "epoch": str(epoch), "is_live": live}
            )
        return {"data": out}

    def lighthouse_database_info(self) -> dict:
        store = self.chain.store
        return {
            "data": {
                "split_slot": str(store.split_slot),
                "slots_per_snapshot": str(store.slots_per_snapshot),
                "anchor_slot": str(self.chain.oldest_block_slot),
                "head_slot": str(self.chain.head_state.slot),
                "hot_states_cached": self.chain._states.hot_count(),
                "known_block_roots": len(self.chain._states),
            }
        }

    def lighthouse_proto_array(self) -> dict:
        """The raw fork-choice nodes (reference /lighthouse/proto_array)."""
        pa = self.chain.fork_choice.proto.proto_array
        return {
            "data": [
                {
                    "root": hexs(n.root),
                    "slot": str(n.slot),
                    "parent": n.parent,
                    "weight": str(n.weight),
                    "justified_epoch": str(n.justified_checkpoint[0]),
                    "finalized_epoch": str(n.finalized_checkpoint[0]),
                    "execution_status": n.execution_status,
                    "best_child": n.best_child,
                    "best_descendant": n.best_descendant,
                }
                for n in pa.nodes
            ]
        }

    def lighthouse_validator_count(self) -> dict:
        """UI endpoint: validator registry broken down by status."""
        s = self.chain.head_state
        epoch = compute_epoch_at_slot(s.slot, self.chain.preset)
        counts = {"active_ongoing": 0, "pending": 0, "exited": 0, "slashed": 0}
        for v in s.validators:
            if v.slashed:
                counts["slashed"] += 1
            elif v.activation_epoch > epoch:
                counts["pending"] += 1
            elif epoch < v.exit_epoch:
                counts["active_ongoing"] += 1
            else:
                counts["exited"] += 1
        return {"data": {k: str(n) for k, n in counts.items()}}

    def _canonical_blocks_in_range(
        self, start_slot: int, end_slot: int
    ) -> list:
        """Canonical (root, signed_block) pairs with start <= slot <= end,
        oldest first, via the parent walk from the head. The walk runs
        from the head down to start_slot, so callers must bound the range
        BEFORE calling."""
        root = self.chain.head_root
        blocks = []
        while root is not None:
            blk = self.chain.store.get_block_any_temperature(root)
            if blk is None:
                break
            if blk.message.slot < start_slot:
                break
            if blk.message.slot <= end_slot:
                blocks.append((root, blk))
            parent = bytes(blk.message.parent_root)
            if not any(parent):
                break
            root = parent
        blocks.reverse()
        return blocks

    def lighthouse_block_packing(self, start_slot: int, end_slot: int) -> dict:
        """Per-block packing efficiency over a canonical slot range
        (block_packing_efficiency.rs): unique attester coverage each block
        actually included."""
        head_slot = int(self.chain.head_state.slot)
        if end_slot - start_slot > 256 or head_slot - start_slot > 256:
            raise ApiError(
                400, "range too wide (max 256 slots, within 256 of head)"
            )
        out = []
        for root, blk in self._canonical_blocks_in_range(start_slot, end_slot):
            atts = blk.message.body.attestations
            unique = set()
            for att in atts:
                key = att.data.tree_hash_root()
                for pos, bit in enumerate(att.aggregation_bits):
                    if bit:
                        unique.add((key, pos))
            out.append(
                {
                    "slot": str(blk.message.slot),
                    "block_root": hexs(root),
                    "attestations_included": len(atts),
                    "attester_slots_covered": len(unique),
                }
            )
        return {"data": out}

    def lighthouse_block_rewards(self, start_slot: int, end_slot: int) -> dict:
        """Per-block proposer reward over a canonical slot range
        (block_rewards.rs): replay each block on its parent state and
        report the proposer's balance delta (at non-boundary slots the
        only thing moving the proposer's balance is the block itself:
        attestation-inclusion, sync-aggregate, and slashing rewards).
        Exact from altair on, where the spec pays proposers at block
        processing; phase0 pays attestation-inclusion rewards at epoch
        processing, so phase0 rows report only the immediate (slashing)
        component."""
        from ..state_transition import (
            BlockSignatureStrategy,
            clone_state,
            per_block_processing,
            process_slots,
        )

        head_slot = int(self.chain.head_state.slot)
        if end_slot - start_slot > 64 or head_slot - start_slot > 256:
            raise ApiError(
                400, "range too wide (max 64 slots, within 256 of head)"
            )
        out = []
        for root, blk in self._canonical_blocks_in_range(start_slot, end_slot):
            parent_state = self.chain._states.get(
                bytes(blk.message.parent_root)
            )
            if parent_state is None:
                continue  # pre-finalization parents: replay not retained
            st = process_slots(
                clone_state(parent_state),
                blk.message.slot,
                self.chain.preset,
                self.chain.spec,
            )
            proposer = blk.message.proposer_index
            before = st.balances[proposer]
            per_block_processing(
                st,
                blk,
                self.chain.preset,
                self.chain.spec,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
            )
            out.append(
                {
                    "slot": str(blk.message.slot),
                    "block_root": hexs(root),
                    "proposer_index": str(proposer),
                    "total_reward": str(st.balances[proposer] - before),
                }
            )
        return {"data": out}

    def get_version(self) -> dict:
        return {"data": {"version": API_VERSION}}

    def get_syncing(self) -> dict:
        head = self.chain.head_state.slot
        current = self.chain.current_slot
        return {
            "data": {
                "head_slot": str(head),
                "sync_distance": str(max(current - head, 0)),
                "is_syncing": current > head + 1,
            }
        }
