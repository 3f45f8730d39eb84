"""Prometheus-style metrics registry: the port's copy of the registry
types of lighthouse_tpu/utils/metrics.py (`Counter`, `Gauge`, `Histogram`,
`LabeledGauge`, `Registry`, `slot_delay_seconds`, `observe_slot_delay`)
and of the metric families that the verification seam feeds: backend
degradation, the pipeline, message aggregation, the scheduler, and the
device telemetry of backends/torch_cuda.py; and the families that the
gossip attestation batches (chain/attestation_verification.py, with its
bisection), the beacon processor, block import (chain/beacon_chain.py,
chain/block_verification.py), the store's journal (store/kv.py),
speculative verification (speculate/), the validator monitor
(chain/validator_monitor.py), the serving tier (serving/) and the task
executor (utils/executor.py) feed.

Exported names, types and help texts are the JAX package's, so the two
registries compare line by line. The rest of the chain family (the
observed-delay and equivocation families, which network/ feeds) and the
network family wait for the modules that feed them."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def escape_help(text: str) -> str:
    """Prometheus exposition-format HELP escaping: backslash and newline
    only (a raw newline would split the HELP line and corrupt the whole
    scrape)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Exposition-format label-value escaping: backslash, double-quote,
    newline (an endpoint URL containing `"` must not terminate the label
    early)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def expose(self) -> list[str]:
        return [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} counter",
            f"{self.name} {self.value:g}",
        ]


class Gauge:
    """Thread-safe like Counter (a queue-depth gauge is written from
    every worker); `inc`/`dec` spare call sites the read-modify-write."""

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def get(self) -> float:
        with self._lock:
            return self.value

    def expose(self) -> list[str]:
        return [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
            f"{self.name} {self.value:g}",
        ]


class Histogram:
    def __init__(self, name: str, help_: str, buckets=_DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    @contextmanager
    def time(self):
        """The start_timer/stop_timer seat (lighthouse_metrics)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def snapshot(self) -> tuple:
        """Point-in-time copy of (bucket_counts, count, sum): the delta
        base for windowed quantiles (scenario SLO checks subtract a
        start-of-run snapshot so process-global history doesn't bleed
        into the scenario's verdict)."""
        with self._lock:
            return list(self.bucket_counts), self.count, self.sum

    def quantile(self, q: float, since: tuple | None = None) -> float | None:
        """Upper-bound estimate of the q-quantile from the bucket counts
        (linear within the winning bucket's upper edge, like PromQL's
        histogram_quantile). `since` subtracts an earlier snapshot().
        None when the (windowed) histogram is empty; the overflow bucket
        reports the largest finite edge."""
        with self._lock:
            counts = list(self.bucket_counts)
        if since is not None:
            base = since[0]
            counts = [c - b for c, b in zip(counts, base)]
        total = sum(counts)
        if total <= 0:
            return None
        rank = q * total
        cum = 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            if cum >= rank:
                return edge
        return self.buckets[-1]

    def expose(self) -> list[str]:
        out = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        cum = 0
        for b, c in zip(self.buckets, self.bucket_counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        out.append(f"{self.name}_sum {self.sum:g}")
        out.append(f"{self.name}_count {self.count}")
        return out


class LabeledGauge:
    """A one-label gauge family (`name{label="x"} v` per child): the
    minimal labels support the resilience layer needs for per-endpoint
    health scores without pulling in a full label model."""

    def __init__(self, name: str, help_: str, label: str = "endpoint"):
        self.name = name
        self.help = help_
        self.label = label
        self._children: dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, label_value: str, value: float) -> None:
        with self._lock:
            self._children[str(label_value)] = value

    def get(self, label_value: str) -> float | None:
        with self._lock:
            return self._children.get(str(label_value))

    def expose(self) -> list[str]:
        out = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
        ]
        with self._lock:
            items = sorted(self._children.items())
        for lv, v in items:
            out.append(
                f'{self.name}{{{self.label}="{escape_label_value(lv)}"}}'
                f" {v:g}"
            )
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help_, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, **kw)
            elif not isinstance(m, cls):
                # registry hygiene: one name, one family type -- silently
                # handing a Counter to a gauge() caller corrupts both
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS):
        return self._get(Histogram, name, help_, buckets=buckets)

    def labeled_gauge(self, name: str, help_: str = "", label: str = "endpoint"):
        return self._get(LabeledGauge, name, help_, label=label)

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


# the process-global registry
REGISTRY = Registry()

# -- the resilience family (resilience/primitives.py: retries, the circuit
# breaker, endpoint health) and BLS backend degradation (backends/fallback.py)

RETRY_ATTEMPTS = REGISTRY.counter(
    "resilience_retry_attempts_total",
    "Operations re-attempted by a RetryPolicy",
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "resilience_breaker_transitions_total",
    "Circuit-breaker state transitions (closed/open/half-open)",
)
BLS_FALLBACK_EVENTS = REGISTRY.counter(
    "bls_backend_fallback_total",
    "Batches degraded from the primary BLS backend to the fallback",
)
BLS_USING_FALLBACK = REGISTRY.gauge(
    "bls_backend_using_fallback",
    "1 while BLS verification is degraded to the fallback backend",
)
ENDPOINT_HEALTH = REGISTRY.labeled_gauge(
    "resilience_endpoint_health_score",
    "Recent-outcome health score per tracked endpoint (0..1)",
    label="endpoint",
)

# -- the verification-pipeline family (crypto/bls/pipeline.py and the
# gather route of backends/torch_cuda.py) -----------------------------------

BLS_PIPELINE_DEPTH = REGISTRY.gauge(
    "bls_pipeline_depth",
    "Configured max in-flight batches of the async verify pipeline",
)
BLS_PIPELINE_OCCUPANCY = REGISTRY.gauge(
    "bls_pipeline_occupancy",
    "Batches currently dispatched to device and not yet resolved",
)
BLS_PIPELINE_OCCUPANCY_PEAK = REGISTRY.gauge(
    "bls_pipeline_occupancy_peak",
    "High-water mark of in-flight batches since process start",
)
BLS_PIPELINE_BATCHES = REGISTRY.counter(
    "bls_pipeline_batches_total",
    "Batches submitted through verify_signature_sets_async",
)
BLS_GATHER_HITS = REGISTRY.counter(
    "bls_device_gather_batches_total",
    "Batches whose pubkeys were gathered from the device-resident table",
)
BLS_GATHER_MISSES = REGISTRY.counter(
    "bls_host_packed_batches_total",
    "Batches that fell back to per-key host limb packing",
)

# -- the block import family (chain/beacon_chain.py, chain/block_verification
# .py; the beacon_chain metric family of metrics.rs:37-80) -----------------

BLOCK_PROCESSING_TIMES = REGISTRY.histogram(
    "beacon_block_processing_seconds", "Full block import time"
)
BLOCK_SIGNATURE_TIMES = REGISTRY.histogram(
    "beacon_block_processing_signature_seconds",
    "Signature batch verification phase",
)
BLOCK_TRANSITION_TIMES = REGISTRY.histogram(
    "beacon_block_processing_state_transition_seconds",
    "per_block/per_slot state transition phase",
)
BLOCK_STATE_ROOT_TIMES = REGISTRY.histogram(
    "beacon_block_processing_state_root_seconds", "State-root computation"
)
BLOCK_FORK_CHOICE_TIMES = REGISTRY.histogram(
    "beacon_block_processing_fork_choice_seconds", "Fork-choice import + head"
)
BLOCKS_IMPORTED = REGISTRY.counter(
    "beacon_blocks_imported_total", "Blocks successfully imported"
)
BLOCKS_REJECTED = REGISTRY.counter(
    "beacon_blocks_rejected_total", "Blocks rejected on import"
)
BLOCK_EQUIVOCATIONS = REGISTRY.counter(
    "beacon_block_equivocations_total",
    "Gossip blocks IGNOREd as a second distinct proposal from the same "
    "(slot, proposer) — handed to the slasher, never imported via gossip",
)

# -- the store: write-ahead journal (store/kv.py), fsck, the native log ------

STORE_JOURNAL_REPLAYS = REGISTRY.counter(
    "store_journal_replays_total",
    "Committed write-ahead batches re-applied on store reopen (the crash "
    "hit mid-apply; redo)",
)
STORE_JOURNAL_ROLLBACKS = REGISTRY.counter(
    "store_journal_rollbacks_total",
    "Torn/uncommitted write-ahead batches discarded on store reopen (the "
    "crash hit the intent write; the batch never happened)",
)
STORE_FSCK_RUNS = REGISTRY.counter(
    "store_fsck_runs_total", "db fsck consistency walks"
)
STORE_FSCK_FAILURES = REGISTRY.counter(
    "store_fsck_issues_total", "Consistency violations found by db fsck"
)
# NativeStore (store/native_kv.py) open-time recovery outcomes: the native
# twin of the journal counters above, read back from the C side via
# kv_recovery_stats at every open.
STORE_NATIVE_REPLAYED = REGISTRY.counter(
    "store_native_replayed_batches_total",
    "Committed native-log batches re-applied during store open replay",
)
STORE_NATIVE_ROLLED_BACK = REGISTRY.counter(
    "store_native_rolled_back_batches_total",
    "Uncommitted native-log batches dropped during store open replay "
    "(the crash hit between BATCH_BEGIN and BATCH_COMMIT)",
)
STORE_NATIVE_TRUNCATED = REGISTRY.counter(
    "store_native_truncated_bytes_total",
    "Torn native-log tail bytes truncated during store open replay",
)

# -- the gossip attestation batch family (chain/attestation_verification.py,
# the beacon_chain metric family of metrics.rs:37-80) ----------------------

ATTN_BATCH_SETUP_TIMES = REGISTRY.histogram(
    "beacon_attestation_batch_setup_seconds",
    "Gossip attestation batch: checks + set building",
)
ATTN_BATCH_VERIFY_TIMES = REGISTRY.histogram(
    "beacon_attestation_batch_verify_seconds",
    "Gossip attestation batch: worker-visible wait for the signature "
    "verdict (+bisection); under the async pipeline device compute "
    "overlaps the next batch's marshalling, so this is residual wait, "
    "not raw device time",
)
ATTESTATIONS_PROCESSED = REGISTRY.counter(
    "beacon_attestations_processed_total", "Gossip attestations verified"
)
BLS_BISECTION_CALLS = REGISTRY.counter(
    "bls_bisection_backend_calls_total",
    "Extra backend calls spent isolating invalid sets by bisection",
)
BLS_BISECTION_BAD_ITEMS = REGISTRY.counter(
    "bls_bisection_bad_items_total",
    "Invalid items isolated (and attributed) by the bisection fallback",
)

# -- the message-aggregation family (backends/torch_cuda.py dispatch, the
# weight draws of torch_cuda and cpu) --------------------------------------

BLS_MILLER_PAIRS = REGISTRY.counter(
    "bls_miller_pairs_total",
    "Miller-loop pairs dispatched across all verification batches",
)
BLS_MILLER_PAIRS_LAST = REGISTRY.gauge(
    "bls_miller_pairs_last_batch",
    "Miller-loop pairs of the most recently dispatched batch (scales "
    "with bucketed distinct messages on the aggregated path, bucketed "
    "sets otherwise)",
)
BLS_AGGREGATION_RATIO = REGISTRY.gauge(
    "bls_aggregation_ratio",
    "Signature sets per Miller pair in the most recent batch (~1 "
    "unaggregated; ~sets/messages on the mega-pairing path)",
)
BLS_AGGREGATED_BATCHES = REGISTRY.counter(
    "bls_aggregated_batches_total",
    "Batches verified through the per-message mega-pairing path",
)
BLS_WEIGHT_REDRAWS = REGISTRY.counter(
    "bls_weight_redraws_total",
    "Random-linear-combination batch weights redrawn by the nonzero/"
    "independence guard (a zero or within-batch colliding draw would let "
    "a forged set cancel inside the combination)",
)

# -- slot-relative delay (the scheduler's verdict-delay histograms and block
# import's milestones) --------------------------------------------------------

_SLOT_DELAY_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
)

BLOCK_OBSERVED_DELAY = REGISTRY.histogram(
    "beacon_block_observed_delay_seconds",
    "Slot-start to gossip arrival of the block",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLOCK_VERIFIED_DELAY = REGISTRY.histogram(
    "beacon_block_verified_delay_seconds",
    "Slot-start to full signature verification of the block",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLOCK_IMPORTED_DELAY = REGISTRY.histogram(
    "beacon_block_imported_delay_seconds",
    "Slot-start to completed import (store + fork choice) of the block",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLOCK_HEAD_DELAY = REGISTRY.histogram(
    "beacon_block_head_delay_seconds",
    "Slot-start to the block becoming the canonical head",
    buckets=_SLOT_DELAY_BUCKETS,
)


def slot_delay_seconds(slot_clock, slot: int) -> float:
    """Seconds past `slot`'s start on the INJECTED slot clock (negative
    when observed early, e.g. a locally-produced block)."""
    start = slot_clock.genesis_time + slot * slot_clock.seconds_per_slot
    return slot_clock.now() - start

def observe_slot_delay(histogram: Histogram, slot_clock, slot: int) -> None:
    """Record one slot-relative delay sample; the single seat the
    span-wallclock lint rule audits for wall-clock operands."""
    histogram.observe(slot_delay_seconds(slot_clock, slot))

# -- device telemetry (backends/torch_cuda.py marshal/dispatch seam, warm
# pass and PubkeyTable). The `tpu_` prefix is the JAX package's: the names
# stay identical so the two registries compare line by line. The compile
# cache counters count the stage-graph registry's hits and misses: a miss
# is a batch whose bucketed shape captures its stage graphs now. -----------

TPU_COMPILE_CACHE_HITS = REGISTRY.counter(
    "tpu_compile_cache_hits_total",
    "Batches whose bucketed (sets, pubkeys, messages) shape was already "
    "compiled this process",
)
TPU_COMPILE_CACHE_MISSES = REGISTRY.counter(
    "tpu_compile_cache_misses_total",
    "Batches marshalled to a NEW bucketed shape (XLA compile expected)",
)
TPU_WARM_COMPILE_SECONDS = REGISTRY.labeled_gauge(
    "tpu_warm_compile_seconds",
    "Wall seconds the AOT warm pass spent compiling (or cache-loading) "
    "each shape bucket's backend executables",
    label="bucket",
)
TPU_TRANSFER_BYTES = REGISTRY.counter(
    "tpu_transfer_bytes_total",
    "Host-to-device bytes marshalled for verification batches",
)
TPU_MARSHAL_BATCH_BYTES = REGISTRY.gauge(
    "tpu_marshal_batch_bytes",
    "Host-to-device bytes of the most recent marshalled batch",
)
TPU_PUBKEY_TABLE_BYTES = REGISTRY.labeled_gauge(
    "tpu_pubkey_table_bytes",
    "Decompressed pubkey-table bytes RESIDENT PER DEVICE (label: device "
    "id). Replicated tables repeat the full size on every device; the "
    "mesh-sharded table holds ~1/N of the bucketed rows per device",
    label="device",
)
TPU_PUBKEY_GATHER_BYTES = REGISTRY.counter(
    "tpu_pubkey_gather_bytes_total",
    "Pubkey limb-row bytes pulled to the verifying chip by per-batch "
    "gathers from the (sharded) device-resident table",
)
TPU_PUBKEY_GATHER_BATCHES = REGISTRY.counter(
    "tpu_pubkey_gather_batches_total",
    "Verification batches whose pubkeys were gathered from the "
    "device-resident table by validator index",
)
# -- speculative verification (speculate/: committee precompute and
# idle-time next-slot pre-verification; the committee table's size,
# which torch_cuda feeds) ----------------------------------------------

SPECULATE_PRECOMPUTE_ENTRIES = REGISTRY.gauge(
    "speculate_precompute_entries",
    "Per-(slot, committee) aggregate-pubkey precompute entries currently "
    "cached (keyed on the epoch's shuffling seed)",
)
SPECULATE_PRECOMPUTE_HITS = REGISTRY.counter(
    "speculate_precompute_full_hits_total",
    "Indexed-attestation sets whose aggregation bits matched a cached "
    "full-committee aggregate exactly (zero pubkey aggregation on the "
    "critical path)",
)
SPECULATE_PRECOMPUTE_CORRECTIONS = REGISTRY.counter(
    "speculate_precompute_corrections_total",
    "Partial-participation sets served by incremental correction "
    "(cached full aggregate minus absent members)",
)
SPECULATE_PRECOMPUTE_MISSES = REGISTRY.counter(
    "speculate_precompute_misses_total",
    "Indexed-attestation sets that fell through to normal per-set pubkey "
    "aggregation (no entry, stale shuffling key, or member mismatch)",
)
SPECULATE_PRECOMPUTE_INVALIDATIONS = REGISTRY.counter(
    "speculate_precompute_invalidations_total",
    "Precompute entries dropped because a reorg changed the epoch's "
    "shuffling seed (same-shuffling reorgs keep entries)",
)
SPECULATE_PREVERIFIED = REGISTRY.counter(
    "speculate_preverified_total",
    "Expected next-slot aggregates pre-verified during idle device time "
    "and memoized for confirm-on-arrival",
)
SPECULATE_CONFIRMS = REGISTRY.counter(
    "speculate_confirm_hits_total",
    "Arriving aggregates confirmed by speculation-memo lookup instead of "
    "pairing on the critical path",
)
SPECULATE_CONFIRM_MISSES = REGISTRY.counter(
    "speculate_confirm_misses_total",
    "Arriving aggregates with no matching speculation memo (fell through "
    "to the normal verified path)",
)
SPECULATE_MISMATCHES = REGISTRY.counter(
    "speculate_mismatches_total",
    "Arriving aggregates whose memo key matched but whose signature bytes "
    "differed from the pre-verified one (never trusted; full verify)",
)
SPECULATE_IDLE_RUNS = REGISTRY.counter(
    "speculate_idle_runs_total",
    "Idle-time speculation passes actually run by the processor (gated "
    "on queue-wait p95 and in-flight depth)",
)
SPECULATE_TABLE_BYTES = REGISTRY.gauge(
    "speculate_committee_table_bytes",
    "Device-resident per-committee aggregate-pubkey table size in bytes "
    "(lives next to the validator pubkey table in the jax_tpu backend)",
)

# -- continuous-batching scheduler (crypto/bls/scheduler.py); its
# preemption counter keeps the speculation family's name -----------------

SPECULATE_PREEMPTIONS = REGISTRY.counter(
    "speculate_preemptions_total",
    "Speculative batches withheld at a scheduler launch boundary because "
    "real (validator-lane) work was queued; withheld batches stay queued "
    "and launch at the next idle boundary, never dropped",
)
BLS_SCHED_MERGES = REGISTRY.counter(
    "bls_sched_merged_launches_total",
    "Device launches that merged entries from more than one submission "
    "(the continuous-batching win: arrivals ride the next launch)",
)
BLS_SCHED_LAUNCHES = REGISTRY.counter(
    "bls_sched_launches_total",
    "Device launches admitted by the scheduler (merged or singleton)",
)
BLS_SCHED_MERGE_FALLBACKS = REGISTRY.counter(
    "bls_sched_merge_fallbacks_total",
    "Merged launches that verified False and were re-verified per entry "
    "to recover exact per-submission verdicts",
)
BLS_SCHED_PAD_SETS = REGISTRY.counter(
    "bls_sched_pad_sets_total",
    "Padding rows added to reach the nearest WARMED bucket capacity "
    "(the padding tax, numerator)",
)
BLS_SCHED_REAL_SETS = REGISTRY.counter(
    "bls_sched_real_sets_total",
    "Real signature sets admitted through the scheduler (the padding "
    "tax, denominator)",
)
BLS_SCHED_QUEUE_DEPTH = REGISTRY.labeled_gauge(
    "bls_sched_queue_depth",
    "Entries currently queued per lane, sampled at submit/launch",
    label="lane",
)
BLS_SCHED_VERDICT_DELAY_BLOCK = REGISTRY.histogram(
    "bls_sched_verdict_delay_seconds_block",
    "Slot-start to verdict for block-proposal signature batches",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLS_SCHED_VERDICT_DELAY_AGGREGATE = REGISTRY.histogram(
    "bls_sched_verdict_delay_seconds_aggregate",
    "Slot-start to verdict for aggregate-attestation batches",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLS_SCHED_VERDICT_DELAY_UNAGGREGATED = REGISTRY.histogram(
    "bls_sched_verdict_delay_seconds_unaggregated",
    "Slot-start to verdict for unaggregated-attestation batches",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLS_SCHED_VERDICT_DELAY_SYNC = REGISTRY.histogram(
    "bls_sched_verdict_delay_seconds_sync",
    "Slot-start to verdict for sync-committee message/contribution batches",
    buckets=_SLOT_DELAY_BUCKETS,
)
BLS_SCHED_VERDICT_DELAY_SPECULATIVE = REGISTRY.histogram(
    "bls_sched_verdict_delay_seconds_speculative",
    "Slot-start to verdict for speculative idle-time batches",
    buckets=_SLOT_DELAY_BUCKETS,
)
SCHEDULER_VERDICT_DELAY = {
    "block": BLS_SCHED_VERDICT_DELAY_BLOCK,
    "aggregate": BLS_SCHED_VERDICT_DELAY_AGGREGATE,
    "unaggregated": BLS_SCHED_VERDICT_DELAY_UNAGGREGATED,
    "sync": BLS_SCHED_VERDICT_DELAY_SYNC,
    "speculative": BLS_SCHED_VERDICT_DELAY_SPECULATIVE,
}

# -- beacon-processor scheduling family (processor/beacon_processor.py) ------

PROCESSOR_PENDING = REGISTRY.gauge(
    "beacon_processor_work_pending",
    "Work items queued across all processor lanes, not yet claimed",
)
PROCESSOR_QUEUE_WAIT = REGISTRY.histogram(
    "beacon_processor_queue_wait_seconds",
    "Enqueue-to-claim wait of the oldest item in each claimed batch "
    "(tracer clock)",
)


# -- the validator-monitor family (chain/validator_monitor.py) ---------------

VALIDATOR_MONITOR_PROPOSALS = REGISTRY.counter(
    "validator_monitor_blocks_proposed_total",
    "Blocks proposed by monitored validators",
)
VALIDATOR_MONITOR_ATTESTATIONS = REGISTRY.counter(
    "validator_monitor_attestations_total",
    "Attestations by monitored validators seen on-chain or gossip",
)
VALIDATOR_MONITOR_INCLUSION_DELAY = REGISTRY.histogram(
    "validator_monitor_attestation_inclusion_delay_slots",
    "Slots between attestation slot and block inclusion",
    buckets=(1, 2, 3, 4, 8, 16, 32),
)
VALIDATOR_MONITOR_TARGET_MISSES = REGISTRY.counter(
    "validator_monitor_prev_epoch_target_misses_total",
    "Monitored validators that missed the target in an epoch",
)
VALIDATOR_MONITOR_HEAD_MISSES = REGISTRY.counter(
    "validator_monitor_prev_epoch_head_misses_total",
    "Monitored validators that missed the head in an epoch",
)
VALIDATOR_MONITOR_SYNC_SIGNATURES = REGISTRY.counter(
    "validator_monitor_sync_committee_messages_total",
    "Sync-committee messages by monitored validators",
)
VALIDATOR_MONITOR_SLASHED = REGISTRY.counter(
    "validator_monitor_slashings_total",
    "Slashings naming monitored validators",
)

# -- serving tier (serving/: response cache, SSE fan-out, admission) ---------

SERVING_CACHE_HITS = REGISTRY.counter(
    "http_serving_cache_hits_total",
    "GET responses served from the anchored response cache without "
    "invoking the BeaconApi handler",
)
SERVING_CACHE_MISSES = REGISTRY.counter(
    "http_serving_cache_misses_total",
    "Cacheable GETs that had to invoke the underlying handler",
)
SERVING_CACHE_INVALIDATIONS = REGISTRY.counter(
    "http_serving_cache_invalidations_total",
    "Entries dropped because a head/finality event moved their anchor",
)
SERVING_CACHE_ENTRIES = REGISTRY.gauge(
    "http_serving_cache_entries",
    "Entries currently held by the response cache (LRU-bounded)",
)
SERVING_NOT_MODIFIED = REGISTRY.counter(
    "http_serving_not_modified_total",
    "Conditional GETs answered 304 via If-None-Match ETag revalidation",
)
SERVING_SHED_READ_ONLY = REGISTRY.counter(
    "http_serving_shed_read_only_total",
    "Read-only-lane requests shed with 503 + Retry-After under "
    "processor backpressure",
)
SERVING_SHED_DEBUG = REGISTRY.counter(
    "http_serving_shed_debug_total",
    "Debug-lane requests shed with 503 + Retry-After under processor "
    "backpressure",
)
SERVING_SSE_SUBSCRIBERS = REGISTRY.gauge(
    "http_serving_sse_subscribers",
    "Live SSE subscribers currently attached to the event broadcaster",
)
SERVING_SSE_DROPPED = REGISTRY.counter(
    "http_serving_sse_dropped_events_total",
    "Events dropped from per-subscriber ring buffers (slow consumers)",
)
SERVING_SSE_REJECTED = REGISTRY.counter(
    "http_serving_sse_rejected_total",
    "SSE subscriptions refused because the concurrent-subscriber cap "
    "was reached",
)
SERVING_EVENT_RING_DROPPED = REGISTRY.counter(
    "http_serving_event_ring_dropped_total",
    "Oldest events evicted from the bounded replay ring (api.events)",
)
SERVING_COALESCED = REGISTRY.counter(
    "http_serving_coalesced_requests_total",
    "Cache-miss GETs coalesced onto another in-flight computation of the "
    "same (route, params, anchor) key (singleflight followers)",
)

# -- the task-executor metric family (task_executor/src/metrics.rs) -----------

EXECUTOR_TASKS_SPAWNED = REGISTRY.counter(
    "executor_tasks_spawned_total", "Tasks spawned via TaskExecutor"
)
EXECUTOR_TASK_PANICS = REGISTRY.counter(
    "executor_task_panics_total", "Tasks that died with an exception"
)
