"""Typed HTTP client for the Beacon API (reference common/eth2's
BeaconNodeHttpClient). Implements the same duck type as
InProcessBeaconNode, so validator-client services run unchanged across
the process boundary (SURVEY.md section 3.4).

The port's copy of lighthouse_tpu/http_api/client.py.
"""

from __future__ import annotations

import json
import urllib.request
import urllib.error

from ..types import types_for
from ..types.containers import AttestationData
from ..types.presets import Preset


class Eth2ClientError(RuntimeError):
    pass


class BeaconNodeHttpClient:
    def __init__(self, base_url: str, preset: Preset, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.preset = preset
        self.timeout = timeout

    def _get(self, path: str):
        try:
            with urllib.request.urlopen(
                self.base_url + path, timeout=self.timeout
            ) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise Eth2ClientError(f"GET {path}: {e.code} {e.read()!r}") from None
        except urllib.error.URLError as e:
            raise Eth2ClientError(f"GET {path}: {e}") from None

    def _post(self, path: str, payload):
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise Eth2ClientError(f"POST {path}: {e.code} {e.read()!r}") from None
        except urllib.error.URLError as e:
            raise Eth2ClientError(f"POST {path}: {e}") from None

    # -- status --------------------------------------------------------------

    def is_healthy(self) -> bool:
        try:
            self._get("/eth/v1/node/health")
            return True
        except Eth2ClientError:
            return False

    def genesis(self) -> dict:
        return self._get("/eth/v1/beacon/genesis")["data"]

    def syncing(self) -> dict:
        return self._get("/eth/v1/node/syncing")["data"]

    def finality_checkpoints(self, state_id: str = "head") -> dict:
        return self._get(
            f"/eth/v1/beacon/states/{state_id}/finality_checkpoints"
        )["data"]

    # -- signing context & registry -----------------------------------------

    def signing_context(self):
        """Shim with .fork and .genesis_validators_root for domain
        computation, fetched from /genesis and /fork (the reference VC
        builds domains from the same two endpoints)."""
        from types import SimpleNamespace

        from ..types.containers import Fork

        genesis = self.genesis()
        fork = self._get("/eth/v1/beacon/states/head/fork")["data"]
        return SimpleNamespace(
            fork=Fork(
                previous_version=bytes.fromhex(
                    fork["previous_version"].removeprefix("0x")
                ),
                current_version=bytes.fromhex(
                    fork["current_version"].removeprefix("0x")
                ),
                epoch=int(fork["epoch"]),
            ),
            genesis_validators_root=bytes.fromhex(
                genesis["genesis_validators_root"].removeprefix("0x")
            ),
            slot=int(self.syncing()["head_slot"]),
        )

    def validator_index_map(self, pubkeys) -> dict:
        wanted = {bytes(p) for p in pubkeys}
        data = self._get("/eth/v1/beacon/states/head/validators")["data"]
        out = {}
        for row in data:
            pk = bytes.fromhex(row["validator"]["pubkey"].removeprefix("0x"))
            if pk in wanted:
                out[pk] = int(row["index"])
        return out

    # -- duties --------------------------------------------------------------

    def get_proposer_duties(self, epoch: int) -> list[tuple[int, int]]:
        data = self._get(f"/eth/v1/validator/duties/proposer/{epoch}")["data"]
        return [(int(d["slot"]), int(d["validator_index"])) for d in data]

    def get_attester_duties(self, epoch: int, indices) -> list[dict]:
        data = self._post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in indices],
        )["data"]
        return [
            {
                "validator_index": int(d["validator_index"]),
                "slot": int(d["slot"]),
                "committee_index": int(d["committee_index"]),
                "committee_position": int(d["validator_committee_index"]),
                "committee_length": int(d["committee_length"]),
                "committees_at_slot": int(d["committees_at_slot"]),
            }
            for d in data
        ]

    # -- production / publication -------------------------------------------

    def produce_block(self, slot: int, randao_reveal: bytes, graffiti=b""):
        url = (
            f"/eth/v2/validator/blocks/{slot}"
            f"?randao_reveal=0x{bytes(randao_reveal).hex()}"
        )
        if graffiti:
            padded = bytes(graffiti).ljust(32, b"\x00")[:32]
            url += f"&graffiti=0x{padded.hex()}"
        resp = self._get(url)
        from ..types import block_classes_for

        t = types_for(self.preset)
        block_cls, _, _ = block_classes_for(t, resp["version"])
        raw = bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        return block_cls.from_ssz_bytes(raw)

    def publish_block(self, signed_block) -> bytes:
        resp = self._post(
            "/eth/v1/beacon/blocks",
            {
                "version": type(signed_block).fork_name,
                "ssz": "0x" + signed_block.as_ssz_bytes().hex(),
            },
        )
        return bytes.fromhex(resp["data"]["root"].removeprefix("0x"))

    def produce_attestation_data(self, slot: int, committee_index: int):
        resp = self._get(
            f"/eth/v1/validator/attestation_data"
            f"?slot={slot}&committee_index={committee_index}"
        )
        raw = bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        return AttestationData.from_ssz_bytes(raw)

    def publish_attestation(self, attestation) -> None:
        self._post(
            "/eth/v1/beacon/pool/attestations",
            ["0x" + attestation.as_ssz_bytes().hex()],
        )

    def get_aggregate(self, data):
        t = types_for(self.preset)
        try:
            resp = self._get(
                "/eth/v1/validator/aggregate_attestation"
                f"?attestation_data=0x{data.as_ssz_bytes().hex()}"
            )
        except Eth2ClientError:
            return None
        raw = bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        return t.Attestation.from_ssz_bytes(raw)

    def publish_aggregate_and_proof(self, signed_aggregate) -> None:
        self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            ["0x" + signed_aggregate.as_ssz_bytes().hex()],
        )

    def prepare_proposers(self, preparations) -> None:
        self._post(
            "/eth/v1/validator/prepare_beacon_proposer",
            [
                {
                    "validator_index": str(p["validator_index"]),
                    "fee_recipient": "0x" + bytes(p["fee_recipient"]).hex(),
                }
                for p in preparations
            ],
        )

    # -- sync-committee duties over the wire (duties_service/sync.rs) --------

    def get_sync_duties(self, epoch: int, indices) -> list[dict]:
        data = self._post(
            f"/eth/v1/validator/duties/sync/{epoch}",
            [str(i) for i in indices],
        )["data"]
        size = (
            self.preset.sync_committee_size
            // self.preset.sync_committee_subnet_count
        )
        out = []
        for d in data:
            subnets: dict[int, list[int]] = {}
            for i in d["validator_sync_committee_indices"]:
                i = int(i)
                subnets.setdefault(i // size, []).append(i % size)
            out.append(
                {
                    "validator_index": int(d["validator_index"]),
                    "subnets": subnets,
                }
            )
        return out

    def publish_sync_message(self, message, subnet: int = 0) -> None:
        self._post(
            "/eth/v1/beacon/pool/sync_committees",
            [{"ssz": "0x" + message.as_ssz_bytes().hex(), "subnet": subnet}],
        )

    def get_sync_contribution(self, slot: int, block_root: bytes, subnet: int):
        from ..types import types_for as _tf

        try:
            resp = self._get(
                "/eth/v1/validator/sync_committee_contribution"
                f"?slot={slot}&subcommittee_index={subnet}"
                f"&beacon_block_root=0x{bytes(block_root).hex()}"
            )
        except Eth2ClientError:
            return None
        t = _tf(self.preset)
        raw = bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        return t.SyncCommitteeContribution.from_ssz_bytes(raw)

    def publish_contribution_and_proof(self, signed_contribution) -> None:
        self._post(
            "/eth/v1/validator/contribution_and_proofs",
            ["0x" + signed_contribution.as_ssz_bytes().hex()],
        )

    # -- builder registrations over the wire ---------------------------------

    def register_validators(self, registrations) -> None:
        self._post(
            "/eth/v1/validator/register_validator",
            ["0x" + r.as_ssz_bytes().hex() for r in registrations],
        )

    # -- inspection endpoints -------------------------------------------------

    def spec(self) -> dict:
        return self._get("/eth/v1/config/spec")["data"]

    def peers(self) -> list[dict]:
        return self._get("/eth/v1/node/peers")["data"]

    def debug_state(self, state_id: str = "head"):
        from ..types import state_class_for

        resp = self._get(f"/eth/v2/debug/beacon/states/{state_id}")
        t = types_for(self.preset)
        cls = state_class_for(t, resp["version"])
        return cls.from_ssz_bytes(
            bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        )

    def get_block(self, block_id: str = "head"):
        """Decoded SignedBeaconBlock for any block id."""
        from ..types import block_classes_for

        resp = self._get(f"/eth/v2/beacon/blocks/{block_id}")
        t = types_for(self.preset)
        _, signed_cls, _ = block_classes_for(t, resp["version"])
        return signed_cls.from_ssz_bytes(
            bytes.fromhex(resp["data"]["ssz"].removeprefix("0x"))
        )

    def fetch_checkpoint_anchor(self):
        """The finalized (state, block) anchor pair for URL-style
        checkpoint sync (reference client/src/builder.rs:206-340): the
        block names its post-state root, so the state is fetched BY THAT
        ROOT — immune to the head advancing between the two requests."""
        block = self.get_block("finalized")
        state = self.debug_state(
            "0x" + bytes(block.message.state_root).hex()
        )
        return state, block
