"""Eth1 data service (reference beacon_node/eth1/src/service.rs:
deposit-log polling into a DepositCache + BlockCache for eth1-data
voting, with reorg rewind).

Provider interface (duck type — both the in-process `MockEth1Provider`
and the JSON-RPC `JsonRpcEth1Provider` in jsonrpc.py implement it):

    head_number() -> int           # latest block number, -1 if empty
    get_block(number) -> Eth1Block | None
    get_deposit_logs(from_index) -> list[DepositData]   # log order

`update()` is the reference's update loop (service.rs:1-1286): it first
re-validates the cached tip against the remote chain and rewinds the
block cache and deposit tree across reorgs, then appends parent-linked
new blocks and ingests new deposit logs.

The port's copy of lighthouse_tpu/eth1/service.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..resilience.primitives import AllEndpointsFailed, EventLog, HealthTracker
from ..types.containers import Eth1Data
from .deposit_tree import DepositDataTree


class Eth1DepositsUnavailable(RuntimeError):
    """Block production asked for deposits the log cache lacks."""


class Eth1ProviderError(RuntimeError):
    """Endpoint-side failure an eth1 provider surfaces after its own
    client-side retries (jsonrpc.Eth1RpcError subclasses this)."""


class NoEth1ProviderAvailable(ConnectionError):
    """Every ranked eth1 endpoint failed the call."""


# errors a provider endpoint may raise transiently: transport faults
# (ConnectionError covers injected FaultPlan errors, TimeoutError/OSError
# cover sockets and injected hangs) and the providers' own error shape.
# Deliberately NOT bare RuntimeError: NotImplementedError/RecursionError
# are programming errors, not outages, and must propagate.
TRANSIENT_PROVIDER_ERRORS = (ConnectionError, OSError, Eth1ProviderError)


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    timestamp: int
    deposit_count: int
    parent_hash: bytes = bytes(32)


class MockEth1Provider:
    """In-process eth1 chain: injectable blocks + deposit logs + reorgs."""

    def __init__(self):
        self.blocks: list[Eth1Block] = []
        self.deposit_logs: list = []  # (DepositData, block_number)
        self._fork_salt = 0

    def _hash(self, number: int) -> bytes:
        return hashlib.sha256(
            b"eth1"
            + number.to_bytes(8, "little")
            + self._fork_salt.to_bytes(8, "little")
        ).digest()

    def add_block(self, timestamp: int, new_deposits=()) -> Eth1Block:
        number = len(self.blocks)
        for d in new_deposits:
            self.deposit_logs.append((d, number))
        blk = Eth1Block(
            number=number,
            hash=self._hash(number),
            parent_hash=self.blocks[-1].hash if self.blocks else bytes(32),
            timestamp=timestamp,
            deposit_count=len(self.deposit_logs),
        )
        self.blocks.append(blk)
        return blk

    def reorg(self, depth: int) -> None:
        """Drop the top `depth` blocks and their deposit logs; replacement
        blocks hash differently (fork salt)."""
        keep = len(self.blocks) - depth
        self.blocks = self.blocks[:keep]
        self.deposit_logs = [l for l in self.deposit_logs if l[1] < keep]
        self._fork_salt += 1

    # -- provider interface --------------------------------------------------

    def head_number(self) -> int:
        return len(self.blocks) - 1

    def get_block(self, number: int) -> Eth1Block | None:
        if 0 <= number < len(self.blocks):
            return self.blocks[number]
        return None

    def get_deposit_logs(self, from_index: int) -> list:
        return [d for d, _ in self.deposit_logs[from_index:]]


class FallbackEth1Provider:
    """Ranked multi-endpoint eth1 provider (the reference's eth1
    multi-endpoint cache, SURVEY §1 layer 5): implements the same
    provider duck type over a list of endpoints.

    Each call walks the endpoints in HealthTracker order -- recent
    outcomes rank them, demoted endpoints sink to the back until their
    re-probe budget matures -- so a dead primary stops eating the first
    try but is probed again once it may have recovered. A fallback that
    is BEHIND the primary is fine: `Eth1Service.update()` already treats
    a shorter/diverged remote view as a reorg and rewinds, then re-
    extends when the primary returns (chaos-tested in
    tests/test_resilience.py)."""

    def __init__(
        self,
        providers,
        tracker: HealthTracker | None = None,
        events: EventLog | None = None,
    ):
        self.providers = list(providers)
        self.tracker = tracker or HealthTracker(
            window=4, threshold=0.5, reprobe_after_skips=2, name="eth1"
        )
        self.events = events
        self.active_index: int | None = None

    def _call(self, method: str, *args):
        def on_error(i, e):
            if self.events is not None:
                self.events.record(
                    "eth1_endpoint_error", index=i, method=method,
                    error=type(e).__name__,
                )

        try:
            i, out = self.tracker.failover(
                self.providers,
                lambda p: getattr(p, method)(*args),
                retry_on=TRANSIENT_PROVIDER_ERRORS,
                on_error=on_error,
            )
        except AllEndpointsFailed as e:
            raise NoEth1ProviderAvailable(
                f"all {len(self.providers)} eth1 endpoints failed {method}"
            ) from e.last
        if self.events is not None and self.active_index != i:
            self.events.record("eth1_endpoint_switch", index=i)
        self.active_index = i
        return out

    # -- provider duck type (Eth1Service contract) ---------------------------

    def head_number(self) -> int:
        return self._call("head_number")

    def get_block(self, number: int):
        return self._call("get_block", number)

    def get_deposit_logs(self, from_index: int) -> list:
        return self._call("get_deposit_logs", from_index)

    def reset_log_scan(self) -> None:
        """Fan out to EVERY endpoint that keeps a scan watermark: after a
        reorg, a later failover to an endpoint with a stale watermark
        must not resurrect reorged-out logs."""
        for p in self.providers:
            reset = getattr(p, "reset_log_scan", None)
            if reset is None:
                continue
            try:
                reset()
            except TRANSIENT_PROVIDER_ERRORS:
                # the endpoint is down; its watermark resets when its
                # transport reconnects (reset_log_scan is local state in
                # every real provider, so this is fault-injection only)
                continue


class Eth1Service:
    def __init__(self, provider, follow_distance: int = 4):
        # a list of endpoints gets the ranked-fallback treatment; a bare
        # provider keeps the original single-endpoint behavior
        if isinstance(provider, (list, tuple)):
            provider = FallbackEth1Provider(provider)
        self.provider = provider
        self.follow_distance = follow_distance
        self.deposit_tree = DepositDataTree()
        self.block_cache: list[Eth1Block] = []
        self._deposit_data: list = []  # log order, parallel to tree leaves

    # -- polling (service.rs update loop) -----------------------------------

    def update(self) -> None:
        # 1. reorg rewind: pop cached tips the remote chain no longer has
        rewound = False
        while self.block_cache:
            tip = self.block_cache[-1]
            remote = self.provider.get_block(tip.number)
            if remote is not None and remote.hash == tip.hash:
                break
            self.block_cache.pop()
            rewound = True
        anchor_deposits = (
            self.block_cache[-1].deposit_count if self.block_cache else 0
        )
        truncated = len(self._deposit_data) > anchor_deposits
        if truncated:
            self.deposit_tree.truncate(anchor_deposits)
            del self._deposit_data[anchor_deposits:]
        if (rewound or truncated) and hasattr(self.provider, "reset_log_scan"):
            # a reorg can replace same-numbered blocks whose logs an
            # incremental scanner would skip; force a full rescan. The
            # truncated-without-rewind case matters too: logs may have been
            # scanned past the cached tip before the reorg (the provider
            # watermark leads the block cache), so a tip match alone does
            # not prove the scanned logs are canonical.
            self.provider.reset_log_scan()

        # 2. ingest deposit logs BEFORE extending the block cache: a
        # transport failure between the two steps must never leave cached
        # blocks whose deposit_count exceeds the tree (the eth1 vote's
        # deposit_root would silently not cover its deposit_count)
        for log in self.provider.get_deposit_logs(len(self._deposit_data)):
            self.deposit_tree.push(log)
            self._deposit_data.append(log)

        # 3. append parent-linked new blocks up to the remote head, never
        # past what the deposit tree can prove
        head = self.provider.head_number()
        start = self.block_cache[-1].number + 1 if self.block_cache else 0
        for number in range(start, head + 1):
            blk = self.provider.get_block(number)
            if blk is None:
                break
            if self.block_cache and blk.parent_hash != self.block_cache[-1].hash:
                break  # raced another reorg; next update rewinds
            if blk.deposit_count > len(self._deposit_data):
                break  # logs for this block not ingested yet; next update
            self.block_cache.append(blk)

    # -- eth1 data voting (eth1_data aggregation) ---------------------------

    def eth1_data_for_block(self, state) -> Eth1Data:
        """The eth1 vote: follow-distance block's snapshot; falls back to
        the state's current eth1_data when the cache is too shallow."""
        if len(self.block_cache) <= self.follow_distance:
            return state.eth1_data
        blk = self.block_cache[-1 - self.follow_distance]
        return Eth1Data(
            deposit_root=self.deposit_tree.root(blk.deposit_count),
            deposit_count=blk.deposit_count,
            block_hash=blk.hash,
        )

    def deposits_for_block(self, state, max_deposits: int) -> list:
        """Deposits owed by the state (eth1_deposit_index..deposit_count),
        proved against the state's eth1_data root. Raises when the local
        log cache has not ingested the owed range yet -- the spec obliges
        the block to carry exactly these deposits, so production must fail
        loudly rather than build an invalid (or crashing) block."""
        start = state.eth1_deposit_index
        end = min(state.eth1_data.deposit_count, start + max_deposits)
        if end > len(self._deposit_data):
            raise Eth1DepositsUnavailable(
                f"state owes deposits [{start}, {end}) but only "
                f"{len(self._deposit_data)} logs are ingested"
            )
        count = state.eth1_data.deposit_count
        return [
            self.deposit_tree.deposit(i, self._deposit_data[i], count)
            for i in range(start, end)
        ]
