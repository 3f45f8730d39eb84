"""EIP-3076 slashing-protection database (reference
validator_client/slashing_protection/src/slashing_database.rs +
interchange.rs): refuses locally-signed double/surround votes and double
proposals, with JSON interchange import/export.

SQLite via the stdlib, same storage seat as the reference's rusqlite. All
checks and insertions happen in one transaction (check-and-insert must be
atomic, as the reference stresses in its parallel_tests.rs).

The port's copy of lighthouse_tpu/validator_client/slashing_protection.py.
"""

from __future__ import annotations

import json
import sqlite3
import threading

_SCHEMA = """
CREATE TABLE IF NOT EXISTS validators (
    id INTEGER PRIMARY KEY,
    public_key TEXT UNIQUE NOT NULL
);
CREATE TABLE IF NOT EXISTS signed_blocks (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    slot INTEGER NOT NULL,
    signing_root TEXT,
    UNIQUE (validator_id, slot)
);
CREATE TABLE IF NOT EXISTS signed_attestations (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    source_epoch INTEGER NOT NULL,
    target_epoch INTEGER NOT NULL,
    signing_root TEXT,
    UNIQUE (validator_id, target_epoch)
);
"""


class NotSafe(ValueError):
    """Signing refused: would violate EIP-3076."""


class SlashingDatabase:
    def __init__(self, path: str = ":memory:"):
        # one shared connection guarded by a lock: the keymanager HTTP API
        # calls in from handler threads (the reference serializes through
        # rusqlite's pooled connections, slashing_database.rs)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        if path != ":memory:":
            # durability for file-backed databases (the reference's
            # open_with_default_pool sets the same pair): WAL keeps
            # readers unblocked during imports, synchronous=FULL makes
            # every acknowledged signature record survive a power cut —
            # slashing protection is the one database where losing an
            # acknowledged write can later equivocate a validator
            self.conn.execute("PRAGMA journal_mode=WAL")
            self.conn.execute("PRAGMA synchronous=FULL")
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.close()

    # -- registration --------------------------------------------------------

    def register_validator(self, pubkey_hex: str) -> int:
        with self._lock, self.conn:
            return self._register_in_txn(pubkey_hex)

    def _validator_id(self, pubkey_hex: str) -> int:
        row = self.conn.execute(
            "SELECT id FROM validators WHERE public_key = ?", (pubkey_hex,)
        ).fetchone()
        if row is None:
            raise NotSafe(f"validator {pubkey_hex[:18]}… not registered")
        return row[0]

    # -- block proposals (slashing_database.rs check_and_insert_block) ------

    def check_and_insert_block_proposal(
        self, pubkey_hex: str, slot: int, signing_root: bytes
    ) -> None:
        with self._lock, self.conn:  # atomic check-and-insert
            vid = self._validator_id(pubkey_hex)
            row = self.conn.execute(
                "SELECT signing_root FROM signed_blocks "
                "WHERE validator_id = ? AND slot = ?",
                (vid, slot),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root.hex():
                    return  # identical re-sign is safe
                raise NotSafe(f"double block proposal at slot {slot}")
            low = self.conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id = ?",
                (vid,),
            ).fetchone()[0]
            if low is not None and slot <= low:
                # EIP-3076: refuse signing at or below the known maximum
                # (pruning safety under interchange imports)
                raise NotSafe(
                    f"block slot {slot} not above previously signed {low}"
                )
            self.conn.execute(
                "INSERT INTO signed_blocks VALUES (?, ?, ?)",
                (vid, slot, signing_root.hex()),
            )

    # -- attestations (check_and_insert_attestation) ------------------------

    def check_and_insert_attestation(
        self,
        pubkey_hex: str,
        source_epoch: int,
        target_epoch: int,
        signing_root: bytes,
    ) -> None:
        if source_epoch > target_epoch:
            raise NotSafe("attestation source after target")
        with self._lock, self.conn:
            vid = self._validator_id(pubkey_hex)
            # double vote: same target, different root
            row = self.conn.execute(
                "SELECT signing_root FROM signed_attestations "
                "WHERE validator_id = ? AND target_epoch = ?",
                (vid, target_epoch),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root.hex():
                    return
                raise NotSafe(f"double vote at target epoch {target_epoch}")
            # surround checks against every recorded attestation
            surrounding = self.conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch < ? AND target_epoch > ? LIMIT 1",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounding is not None:
                raise NotSafe("attestation is surrounded by a prior vote")
            surrounded = self.conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch > ? AND target_epoch < ? LIMIT 1",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounded is not None:
                raise NotSafe("attestation surrounds a prior vote")
            # monotonic lower bounds (import-pruned history safety)
            min_tgt = self.conn.execute(
                "SELECT MIN(target_epoch) FROM signed_attestations "
                "WHERE validator_id = ?",
                (vid,),
            ).fetchone()[0]
            if min_tgt is not None and target_epoch < min_tgt:
                raise NotSafe("target epoch below pruned history")
            self.conn.execute(
                "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)",
                (vid, source_epoch, target_epoch, signing_root.hex()),
            )

    # -- EIP-3076 interchange (interchange.rs) ------------------------------

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        with self._lock:
            return self._export_in_lock(genesis_validators_root)

    def _export_in_lock(self, genesis_validators_root: bytes) -> dict:
        data = []
        for vid, pubkey in self.conn.execute(
            "SELECT id, public_key FROM validators"
        ):
            blocks = [
                {
                    "slot": str(slot),
                    **({"signing_root": "0x" + sr} if sr else {}),
                }
                for slot, sr in self.conn.execute(
                    "SELECT slot, signing_root FROM signed_blocks "
                    "WHERE validator_id = ?",
                    (vid,),
                )
            ]
            atts = [
                {
                    "source_epoch": str(se),
                    "target_epoch": str(te),
                    **({"signing_root": "0x" + sr} if sr else {}),
                }
                for se, te, sr in self.conn.execute(
                    "SELECT source_epoch, target_epoch, signing_root "
                    "FROM signed_attestations WHERE validator_id = ?",
                    (vid,),
                )
            ]
            data.append(
                {
                    "pubkey": "0x" + pubkey,
                    "signed_blocks": blocks,
                    "signed_attestations": atts,
                }
            )
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x"
                + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(
        self, interchange: dict, genesis_validators_root: bytes | None = None
    ) -> None:
        """EIP-3076: a mismatched genesis_validators_root means the history
        belongs to a DIFFERENT chain and must be rejected."""
        if genesis_validators_root is not None:
            meta_gvr = (
                interchange.get("metadata", {})
                .get("genesis_validators_root", "")
                .removeprefix("0x")
            )
            if meta_gvr != genesis_validators_root.hex():
                raise NotSafe(
                    "interchange genesis_validators_root mismatch"
                )
        # All-or-nothing: every imported entry is validated against the
        # EXISTING history (and the other imported entries) with the same
        # double/surround rules as live signing; any slashable conflict
        # aborts the whole import (reference: interchange import runs each
        # record through the slashing checks, interchange.rs +
        # slashing_database.rs import_interchange_info).
        # `with self.conn` rolls the whole transaction back on any raise:
        # a slashable conflict OR a malformed record anywhere means NO
        # partial import — the database stays byte-identical to its
        # pre-import state (asserted by the crash-safety suite).
        with self._lock, self.conn:
            try:
                for record in interchange.get("data", []):
                    pubkey = record["pubkey"].removeprefix("0x")
                    vid = self._register_in_txn(pubkey)
                    for b in record.get("signed_blocks", []):
                        self._import_block(
                            vid,
                            int(b["slot"]),
                            b.get("signing_root", "0x").removeprefix("0x"),
                        )
                    for a in record.get("signed_attestations", []):
                        self._import_attestation(
                            vid,
                            int(a["source_epoch"]),
                            int(a["target_epoch"]),
                            a.get("signing_root", "0x").removeprefix("0x"),
                        )
            except (KeyError, TypeError, ValueError) as e:
                # a malformed record mid-payload: surface it as the same
                # refusal type as a slashable one (the transaction exit
                # rolls back every prior insert either way)
                if isinstance(e, NotSafe):
                    raise
                raise NotSafe(f"malformed interchange record: {e!r}") from e

    def _register_in_txn(self, pubkey_hex: str) -> int:
        self.conn.execute(
            "INSERT OR IGNORE INTO validators (public_key) VALUES (?)",
            (pubkey_hex,),
        )
        return self.conn.execute(
            "SELECT id FROM validators WHERE public_key = ?", (pubkey_hex,)
        ).fetchone()[0]

    def _import_block(self, vid: int, slot: int, signing_root: str) -> None:
        row = self.conn.execute(
            "SELECT signing_root FROM signed_blocks "
            "WHERE validator_id = ? AND slot = ?",
            (vid, slot),
        ).fetchone()
        if row is not None:
            if row[0] == signing_root or not row[0] or not signing_root:
                return  # identical (or unknown-root) re-import is idempotent
            raise NotSafe(
                f"interchange contains a conflicting block at slot {slot}"
            )
        self.conn.execute(
            "INSERT INTO signed_blocks VALUES (?, ?, ?)",
            (vid, slot, signing_root),
        )

    def _import_attestation(
        self, vid: int, source: int, target: int, signing_root: str
    ) -> None:
        if source > target:
            raise NotSafe("interchange attestation source after target")
        row = self.conn.execute(
            "SELECT signing_root FROM signed_attestations "
            "WHERE validator_id = ? AND target_epoch = ?",
            (vid, target),
        ).fetchone()
        if row is not None:
            if row[0] == signing_root or not row[0] or not signing_root:
                return
            raise NotSafe(
                f"interchange contains a double vote at target {target}"
            )
        if self.conn.execute(
            "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
            "AND source_epoch < ? AND target_epoch > ? LIMIT 1",
            (vid, source, target),
        ).fetchone():
            raise NotSafe("interchange attestation surrounded by history")
        if self.conn.execute(
            "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
            "AND source_epoch > ? AND target_epoch < ? LIMIT 1",
            (vid, source, target),
        ).fetchone():
            raise NotSafe("interchange attestation surrounds history")
        self.conn.execute(
            "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)",
            (vid, source, target, signing_root),
        )

    def export_json(self, genesis_validators_root: bytes) -> str:
        return json.dumps(self.export_interchange(genesis_validators_root))

    def import_json(
        self, payload: str, genesis_validators_root: bytes | None = None
    ) -> None:
        self.import_interchange(json.loads(payload), genesis_validators_root)
