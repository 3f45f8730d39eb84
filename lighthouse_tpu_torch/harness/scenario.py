"""Deterministic large-scale scenario harness (the reference's
testing/simulator driven to adversarial conditions): a seeded,
bit-replayable runner that drives tens-to-hundreds of in-process nodes
through composable adversarial phases — network partitions, peer churn,
equivocation storms, long non-finality, mid-scenario crash-recovery —
while an invariant checker asserts consensus SAFETY every slot and an
SLO checker asserts LIVENESS/latency properties at scenario end from the
shared metrics registry and the exported trace.

The DSL: a :class:`ScenarioPlan` is a seed plus an ordered tuple of
:class:`Phase` knobs (split/heal, withhold fraction, storm cadences,
crash schedule, churn) and an :class:`SLO` budget. ``run_scenario``
executes it; running the same plan twice exports a byte-identical trace
and identical final heads (``assert_bit_identical_replay``) — every
source of schedule is a ``random.Random(seed)``, every clock injected.

Safety invariants (asserted every slot, every live honest node):
  * finality is monotonic per node;
  * no two honest nodes ever finalize different roots at one epoch
    (single finalized chain);
  * the head never sits below the finalized slot, and descends from the
    finalized block;
  * no Byzantine artifact (forged block, equivocating second proposal)
    is ever imported via gossip by an honest node.

Liveness/SLO properties (scenario end, windowed over the run):
  * post-heal/post-recovery finality reaches the plan's floor and heads
    converge;
  * p95 `beacon_block_{observed,imported}_delay_seconds` within bounds;
  * retry/breaker/bisection counters within budget;
  * every node's store is `db fsck`-clean (including the freezer
    decodability walk) — the crash-recovery and long-non-finality
    scenarios lean on this.

The port's copy of lighthouse_tpu/harness/scenario.py. The port's own
additions: the `device` keyword of `run_scenario` and
`assert_bit_identical_replay`, passed to the Simulator and so to every
node chain (None is the card, "cpu" only when asked; it is not a plan
field, so plans and corpus JSON stay the JAX package's), and the
backend's device restored beside its name when the run ends.
"""

from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass, field

from ..resilience.crash import CrashPlan
from ..resilience.faults import FaultPlan
from ..resilience.primitives import VirtualClock
from ..types import MINIMAL, ChainSpec
from ..utils import metrics as M
from ..utils import tracing
from ..validator_client.byzantine import ByzPlan


class InvariantViolation(AssertionError):
    """A consensus-safety invariant failed; scenarios fail FAST."""


@dataclass(frozen=True)
class Phase:
    """One adversarial phase: `slots` of simulated time under these
    knobs. Knobs compose — a phase can partition AND storm AND crash."""

    name: str
    slots: int
    # network: node-index groups that cannot reach each other; heal=True
    # removes any split and range-syncs everyone at phase start
    partition: tuple = None
    heal: bool = False
    # participation: fraction of validators withheld (offline) this phase
    withhold_fraction: float = 0.0
    # storms (every N slots of the phase; 0 = never)
    equivocate_every: int = 0
    forge_every: int = 0
    conflicting_atts_every: int = 0
    # churn at phase start
    join_nodes: int = 0
    leave_nodes: tuple = ()
    rejoin_nodes: tuple = ()
    # crash-recovery: arm node `crash_node`'s CrashPlan to die
    # `crash_after_ops` store mutations into the phase; the runner
    # reopens it (WAL recovery + fsck + re-sync) when it dies
    crash_node: int | None = None
    crash_after_ops: int = 20
    crash_action: str = "after"
    # None = arm at phase start; an int re-arms the plan that many slots
    # INTO the phase (crash DURING non-finality / mid-storm composition)
    crash_arm_at: int | None = None
    # transport fault rates for the phase (seeded FaultPlan on req/resp)
    error_rate: float = 0.0
    delay_rate: float = 0.0
    # mid-phase re-rating: ((slot_offset, error_rate, delay_rate), ...)
    # applied via FaultPlan.set_rates when the phase reaches slot_offset
    rates_at: tuple = ()
    # Byzantine validator clients: a ByzPlan turns a sampled fraction of
    # each node's homed validators Byzantine for this phase — slashable
    # duties signed through the REAL validator-store path with slashing
    # protection bypassed-and-audited (validator_client/byzantine.py)
    byz: ByzPlan | None = None


@dataclass(frozen=True)
class SLO:
    """End-of-scenario liveness/latency budget."""

    finality_min_epoch: int = 1
    heads_converge: bool = True
    observed_delay_p95_s: float | None = None
    imported_delay_p95_s: float | None = None
    max_retry_attempts: int | None = None
    max_breaker_transitions: int | None = None
    max_bisection_calls: int | None = None
    expect_proposer_slashings: bool = False
    expect_attester_slashings: bool = False
    fsck_clean: bool = True


@dataclass(frozen=True)
class ScenarioPlan:
    name: str
    seed: int = 0
    node_count: int = 4
    validator_count: int = 64
    phases: tuple = ()
    slo: SLO = field(default_factory=SLO)
    attach_slashers: bool = False
    # small values force multi-window hot->cold migrations (the
    # long-non-finality plan exercises the sub-batched path on purpose)
    migration_chunk_slots: int | None = None
    # attach the duty-driven precompute subsystem (speculate/) to every
    # node: aggregate verification rides the committee-aggregate cache
    # and the run asserts the reorg-invalidation + metric-sanity story
    speculate: bool = False
    # route every verification lane through the continuous-batching
    # scheduler (crypto/bls/scheduler.py) for the run: merged padded
    # launches, deadline admission, speculation preemption; the report
    # grows a "cont_batch" section and the run FAILS if a launch ever
    # admitted speculative work while validator-lane work was queued or
    # broke deadline order
    cont_batch: bool = False
    # "memory" (in-process MessageBus) or "wire" (real WireBus TCP
    # sockets under a deterministic WireFabric — same plans, same
    # invariants, same bit-identical replay over actual frames)
    transport: str = "memory"
    # attach a real BeaconApiServer to node 0 and replay a seeded HTTP
    # mix mid-scenario; serving SLOs (validator-lane immunity, cache
    # consistency after reorgs, SSE delivery) become end-of-run checks
    serving: bool = False
    # aggregation-soundness probe families (crypto/bls/adversary.py) run
    # against the REAL cpu oracle at scenario end, seeded from the plan:
    # any accepted forgery raises InvariantViolation, so the fuzzer can
    # carry these probes and shrink a soundness regression like any
    # other safety finding
    aggregation_probes: tuple = ()


@dataclass
class ScenarioResult:
    report: dict
    trace: str  # Chrome trace-event JSON, byte-comparable across replays
    ledger: str = ""  # launch-ledger dump JSON, byte-comparable too


class InvariantChecker:
    """Consensus safety as machine-checked properties, every slot."""

    def __init__(self, sim):
        self.sim = sim
        self.checked_slots = 0
        self._finalized_by_peer: dict[str, int] = {}
        self._finalized_roots: dict[int, bytes] = {}

    def _fail(self, msg: str) -> None:
        raise InvariantViolation(msg)

    def note_restart(self, node) -> None:
        """A node resumed FromStore after a crash: its fork choice
        re-anchors on the persisted head state, whose finalized field may
        trail what the dead process had REALIZED in memory at an epoch
        boundary — that is restart semantics, not a safety regression.
        Reset the peer's monotonicity floor to the resumed value; the
        cross-node epoch→root map still catches any conflicting
        re-finalization."""
        self._finalized_by_peer[node.peer_id] = int(
            node.chain.finalized_checkpoint[0]
        )

    def check_slot(self, slot: int) -> None:
        self.checked_slots += 1
        spe = self.sim.preset.slots_per_epoch
        for node in self.sim.nodes:
            chain = node.chain
            fe, fr = chain.finalized_checkpoint
            fe, fr = int(fe), bytes(fr)
            prev = self._finalized_by_peer.get(node.peer_id, 0)
            if fe < prev:
                self._fail(
                    f"slot {slot}: finality regressed on {node.peer_id}: "
                    f"{fe} < {prev}"
                )
            self._finalized_by_peer[node.peer_id] = fe
            if fe > 0:
                seen = self._finalized_roots.get(fe)
                if seen is None:
                    self._finalized_roots[fe] = fr
                elif seen != fr:
                    self._fail(
                        f"slot {slot}: CONFLICTING finalized checkpoints "
                        f"at epoch {fe}: {seen.hex()[:12]} vs {fr.hex()[:12]}"
                    )
                if chain.head_state.slot < fe * spe:
                    self._fail(
                        f"slot {slot}: {node.peer_id} head slot "
                        f"{chain.head_state.slot} below finalized epoch {fe}"
                    )
                self._check_descent(node, slot, fe, fr)
        for root in self.sim.forged_roots + self.sim.equivocation_roots:
            for node in self.sim.nodes:
                if root in node.chain._states:
                    self._fail(
                        f"slot {slot}: honest {node.peer_id} imported "
                        f"Byzantine block {root.hex()[:12]} via gossip"
                    )

    def _check_descent(self, node, slot, fin_epoch, fin_root) -> None:
        """The head must descend from the finalized block (walk bounded
        head ancestry through the store, both temperatures). A chain
        anchored ABOVE the finalized block (post-crash FromStore resume)
        is unverifiable and passes."""
        chain = node.chain
        if fin_root in (chain.genesis_block_root, chain.head_root):
            return
        fin_blk = chain.store.get_block_any_temperature(fin_root)
        if fin_blk is None:
            return  # genesis header / below this node's anchor
        fin_slot = int(fin_blk.message.slot)
        root = chain.head_root
        for _ in range(4096):
            if root == fin_root:
                return
            blk = chain.store.get_block_any_temperature(root)
            if blk is None:
                return  # walked below the node's anchor: unverifiable
            if int(blk.message.slot) < fin_slot:
                self._fail(
                    f"slot {slot}: {node.peer_id} head does not descend "
                    f"from its finalized block {fin_root.hex()[:12]}"
                )
            root = bytes(blk.message.parent_root)
            if not any(root):
                return
        self._fail(f"slot {slot}: ancestry walk exceeded bound")


def _counter_snapshot() -> dict:
    return {
        "retry_attempts": M.RETRY_ATTEMPTS.value,
        "breaker_transitions": M.BREAKER_TRANSITIONS.value,
        "bisection_calls": M.BLS_BISECTION_CALLS.value,
    }


def _speculate_snapshot() -> dict:
    return {
        "precompute_full_hits": M.SPECULATE_PRECOMPUTE_HITS.value,
        "precompute_corrections": M.SPECULATE_PRECOMPUTE_CORRECTIONS.value,
        "precompute_misses": M.SPECULATE_PRECOMPUTE_MISSES.value,
        "precompute_invalidations": M.SPECULATE_PRECOMPUTE_INVALIDATIONS.value,
        "confirm_hits": M.SPECULATE_CONFIRMS.value,
        "confirm_misses": M.SPECULATE_CONFIRM_MISSES.value,
        "mismatches": M.SPECULATE_MISMATCHES.value,
    }


def run_scenario(plan: ScenarioPlan, device=None) -> ScenarioResult:
    """Execute a plan start to finish; raises InvariantViolation on any
    safety failure, returns the report + trace (SLO failures are listed
    in the report — callers/CI gate on them). The BLS backend is swapped
    to "fake" for the run (scenarios exercise consensus, not pairings)
    and RESTORED on exit, its device with it — an embedding process must
    not be left with an always-accept verifier, nor with its backend
    moved to another device. `device` is every node chain's (None: the
    card)."""
    from ..crypto.bls import api

    prior_backend = api.get_backend_name()
    prior_device = api._DEVICE
    prior_cont_batch = os.environ.get("LIGHTHOUSE_TPU_CONT_BATCH")
    if plan.cont_batch:
        os.environ["LIGHTHOUSE_TPU_CONT_BATCH"] = "1"
    try:
        return _run_scenario(plan, device)
    finally:
        api.set_backend(prior_backend, device=prior_device)
        if plan.cont_batch:
            if prior_cont_batch is None:
                os.environ.pop("LIGHTHOUSE_TPU_CONT_BATCH", None)
            else:
                os.environ["LIGHTHOUSE_TPU_CONT_BATCH"] = prior_cont_batch


def _run_scenario(plan: ScenarioPlan, device=None) -> ScenarioResult:
    from ..crypto.bls.api import set_backend
    from ..network.simulator import Simulator
    from ..store.fsck import run_fsck

    from ..crypto.bls import pipeline as bls_pipeline
    from ..crypto.bls import scheduler as bls_scheduler

    set_backend("fake")
    tracer = tracing.configure(
        rng=random.Random(plan.seed),
        clock=tracing.StepClock(step=1e-6),
        capacity=1 << 16,
    )
    # fresh verify pipeline: its batch ids are process-global and ride
    # span attributes, so a second run must restart the numbering or the
    # replay's trace bytes diverge
    bls_pipeline.configure()
    # same rule for the continuous-batching scheduler: fresh entry seq
    # numbering + empty launch log per run (the env flag is scoped by
    # run_scenario, like the backend swap)
    bls_scheduler.configure()
    # fresh launch ledger riding the scenario's injected StepClock: its
    # dump is part of the bit-replay contract alongside the trace
    from ..obs import ledger as launch_ledger

    led = launch_ledger.configure(capacity=1 << 15)
    spec = ChainSpec.interop()
    preset = MINIMAL
    needs_faults = any(
        p.error_rate or p.delay_rate or p.rates_at for p in plan.phases
    )
    fault_plan = (
        FaultPlan(seed=plan.seed, clock=VirtualClock())
        if needs_faults
        else None
    )
    crash_plans = {
        p.crash_node: CrashPlan(seed=plan.seed)
        for p in plan.phases
        if p.crash_node is not None
    }
    fabric = None
    if plan.transport == "wire":
        from ..network.wire_fabric import WireFabric

        fabric = WireFabric(seed=plan.seed)
    elif plan.transport != "memory":
        raise ValueError(f"unknown transport {plan.transport!r}")
    try:
        sim = Simulator(
            plan.node_count,
            plan.validator_count,
            preset,
            spec,
            fault_plan=fault_plan,
            crash_plans=crash_plans,
            attach_slashers=plan.attach_slashers,
            migration_chunk_slots=plan.migration_chunk_slots,
            speculate=plan.speculate,
            bus=fabric,
            device=device,
        )
        serving = _ServingRig(sim) if plan.serving else None
        try:
            return _drive_plan(
                plan, sim, fault_plan, crash_plans, serving, tracer
            )
        finally:
            if serving is not None:
                serving.stop()
    finally:
        if fabric is not None:
            fabric.close()


def _drive_plan(
    plan: ScenarioPlan, sim, fault_plan, crash_plans, serving, tracer
) -> ScenarioResult:
    from ..store.fsck import run_fsck

    checker = InvariantChecker(sim)
    base_counts = _counter_snapshot()
    speculate_base = _speculate_snapshot() if plan.speculate else None
    observed_base = M.BLOCK_OBSERVED_DELAY.snapshot()
    imported_base = M.BLOCK_IMPORTED_DELAY.snapshot()

    left_peers: set[str] = set()
    crash_recoveries: list[dict] = []
    # continuous batching: a deterministic speculative-lane probe rides
    # every slot, submitted BEFORE the slot's real traffic and resolved
    # after it -- each real launch boundary in between must withhold it
    # (the preemption audit the end-of-run launch-log check asserts is
    # then exercised on every slot, not vacuously true)
    spec_probe_sets = None
    if plan.cont_batch:
        from ..crypto.bls.api import SecretKey, SignatureSet
        from ..crypto.bls import scheduler as bls_scheduler

        probe_sk = SecretKey(0x5BEC)
        probe_msg = b"cont-batch-speculative-probe".ljust(32, b"\x00")
        spec_probe_sets = [
            SignatureSet.single_pubkey(
                probe_sk.sign(probe_msg),
                probe_sk.public_key(),
                probe_msg,
            )
        ]
    slot = 1
    for pi, phase in enumerate(plan.phases):
        prng = random.Random(plan.seed * 1000003 + pi)
        if phase.heal:
            sim.heal()
            sim.sync_all()
        for idx in phase.leave_nodes:
            for n in list(sim.nodes):
                if getattr(n, "sim_index", None) == idx:
                    left_peers.add(n.peer_id)
                    sim.remove_node(n)
        for idx in phase.rejoin_nodes:
            for n in list(sim.dead):
                if getattr(n, "sim_index", None) == idx:
                    left_peers.discard(n.peer_id)
                    rejoined = sim.rejoin_node(n)
                    rejoined.range_sync()
        for _ in range(phase.join_nodes):
            joined = sim.add_node()
            joined.range_sync()
        if phase.partition is not None:
            _partition_by_sim_index(sim, phase.partition)
        if fault_plan is not None:
            fault_plan.set_rates(
                error_rate=phase.error_rate, delay_rate=phase.delay_rate
            )
        if phase.crash_node is not None and phase.crash_arm_at is None:
            crash_plans[phase.crash_node].arm(
                phase.crash_after_ops, action=phase.crash_action
            )
        # per-phase Byzantine roster (clears when the phase has none);
        # its own seeded stream so byz sampling never perturbs the
        # withholding schedule of pre-existing plans
        sim.set_byz_plan(phase.byz, random.Random(plan.seed * 7000003 + pi))
        active = None
        if phase.withhold_fraction:
            withheld = set(
                prng.sample(
                    range(plan.validator_count),
                    int(phase.withhold_fraction * plan.validator_count),
                )
            )
            active = set(range(plan.validator_count)) - withheld
        for s_i in range(phase.slots):
            storm_ready = slot > 2
            # mid-phase composition: re-arm the crash plan / re-rate the
            # fault plan at slot offsets INTO the phase
            if (
                phase.crash_node is not None
                and phase.crash_arm_at == s_i
            ):
                crash_plans[phase.crash_node].arm(
                    phase.crash_after_ops, action=phase.crash_action
                )
            if fault_plan is not None:
                for off, err, delay in phase.rates_at:
                    if off == s_i:
                        fault_plan.set_rates(
                            error_rate=err, delay_rate=delay
                        )
            spec_probe = None
            if spec_probe_sets is not None:
                spec_probe = bls_scheduler.default_scheduler().submit(
                    spec_probe_sets, lane="speculative", slot=slot
                )
            sim.run_slot(
                slot,
                active_validators=active,
                equivocate=bool(
                    storm_ready
                    and phase.equivocate_every
                    and s_i % phase.equivocate_every == 0
                ),
                forge=bool(
                    storm_ready
                    and phase.forge_every
                    and s_i % phase.forge_every == 0
                ),
                byzantine=bool(
                    storm_ready
                    and phase.byz is not None
                    and s_i % max(1, phase.byz.every) == 0
                ),
            )
            if (
                storm_ready
                and phase.conflicting_atts_every
                and s_i % phase.conflicting_atts_every == 0
            ):
                sim.publish_conflicting_attestations(slot)
                sim.drain()
            # mid-scenario crash-recovery: any node whose store killed it
            # (not an intentional leave) reopens through WAL recovery,
            # must be fsck-clean (freezer decodability included), then
            # re-syncs and rejoins the slot loop
            for n in list(sim.dead):
                if n.peer_id in left_peers:
                    continue
                reopened = sim.reopen_node(n)
                checker.note_restart(reopened)
                issues = [str(i) for i in run_fsck(reopened.chain.store)]
                crash_recoveries.append(
                    {
                        "peer": reopened.peer_id,
                        "slot": slot,
                        "journal_recovery":
                            reopened.chain.store.journal_recovery,
                        "fsck_issues": issues,
                    }
                )
                if issues:
                    raise InvariantViolation(
                        f"reopened {reopened.peer_id} is not fsck-clean: "
                        f"{issues}"
                    )
                reopened.range_sync()
                sim.drain()
            if spec_probe is not None and not spec_probe.result():
                raise InvariantViolation(
                    f"slot {slot}: speculative probe verdict flipped -- "
                    "a preempted speculative batch was dropped or "
                    "mis-settled"
                )
            checker.check_slot(slot)
            slot += 1
        if serving is not None:
            # replay the HTTP mix against node 0 with this phase's chaos
            # knobs still installed (mid-partition / mid-storm traffic)
            serving.replay(random.Random(plan.seed * 9000011 + pi))

    # final settle: heal anything still split, sync stragglers
    sim.heal()
    sim.sync_all()
    checker.check_slot(slot)

    # -- SLO evaluation (metrics deltas + trace-derived health) --------------
    from ..utils.monitoring import trace_health_fields

    finalized = max(
        int(n.chain.finalized_checkpoint[0]) for n in sim.nodes
    )
    heads = sorted({n.chain.head_root.hex() for n in sim.nodes})
    deltas = {
        k: v - base_counts[k] for k, v in _counter_snapshot().items()
    }
    observed_p95 = M.BLOCK_OBSERVED_DELAY.quantile(0.95, since=observed_base)
    imported_p95 = M.BLOCK_IMPORTED_DELAY.quantile(0.95, since=imported_base)
    slashings = sum(
        n.slasher_service.proposer_slashings_found
        for n in sim.nodes
        if n.slasher_service is not None
    )
    att_slashings = sum(
        n.slasher_service.attester_slashings_found
        for n in sim.nodes
        if n.slasher_service is not None
    )
    # speculation must NEVER confirm a byz-emitted aggregate by lookup:
    # a confirm accepts without re-verifying, so a byz aggregate in the
    # confirmed audit trail is a safety violation, not an SLO miss
    if sim.byz_aggregate_roots:
        byz_roots = set(sim.byz_aggregate_roots)
        for n in sim.nodes:
            sub = getattr(n.chain, "speculation", None)
            if sub is None:
                continue
            hit = byz_roots & set(sub.confirmed_roots)
            if hit:
                raise InvariantViolation(
                    f"{n.peer_id} speculation confirmed a Byzantine "
                    f"aggregate by lookup: {sorted(hit)[0].hex()[:12]}"
                )
    # aggregation-soundness probes against the REAL cpu oracle (the fake
    # backend the simulation ran on never touches the pairing; the
    # forgeries target the crypto itself, so they verify out-of-band,
    # seeded from the plan for bit-identical replay)
    if plan.aggregation_probes:
        from ..crypto.bls import adversary

        for violation in adversary.audit(
            plan.aggregation_probes, seed=plan.seed, quick=True
        ):
            raise InvariantViolation(f"aggregation-soundness: {violation}")
    fsck_issues: dict[str, list[str]] = {}
    if plan.slo.fsck_clean:
        for n in sim.nodes:
            issues = [str(i) for i in run_fsck(n.chain.store)]
            if issues:
                fsck_issues[n.peer_id] = issues

    slo = plan.slo
    failures: list[str] = []
    if slo.heads_converge and len(heads) != 1:
        failures.append(f"heads diverged at scenario end: {len(heads)}")
    if finalized < slo.finality_min_epoch:
        failures.append(
            f"finalized epoch {finalized} < floor {slo.finality_min_epoch}"
        )
    if (
        slo.observed_delay_p95_s is not None
        and observed_p95 is not None
        and observed_p95 > slo.observed_delay_p95_s
    ):
        failures.append(
            f"observed-delay p95 {observed_p95} > {slo.observed_delay_p95_s}"
        )
    if (
        slo.imported_delay_p95_s is not None
        and imported_p95 is not None
        and imported_p95 > slo.imported_delay_p95_s
    ):
        failures.append(
            f"imported-delay p95 {imported_p95} > {slo.imported_delay_p95_s}"
        )
    for key, bound in (
        ("retry_attempts", slo.max_retry_attempts),
        ("breaker_transitions", slo.max_breaker_transitions),
        ("bisection_calls", slo.max_bisection_calls),
    ):
        if bound is not None and deltas[key] > bound:
            failures.append(f"{key} {deltas[key]} > budget {bound}")
    if slo.expect_proposer_slashings and slashings == 0:
        failures.append("no proposer slashing detected during the storm")
    if slo.expect_attester_slashings and att_slashings == 0:
        failures.append("no attester slashing detected during the storm")
    if fsck_issues:
        failures.append(f"fsck issues: {fsck_issues}")
    serving_report = None
    if serving is not None:
        serving_report = serving.report()
        failures.extend(serving_report["failures"])

    speculation = None
    if speculate_base is not None:
        speculation = {
            k: v - speculate_base[k]
            for k, v in _speculate_snapshot().items()
        }
        speculation["precompute_entries"] = sum(
            len(n.chain.speculation.precompute)
            for n in sim.nodes
            if getattr(n.chain, "speculation", None) is not None
        )

    # the scenario's ledger (configured fresh by _run_scenario): audited
    # against the scheduler's launch log below and dumped into the result
    from ..obs import ledger as launch_ledger

    led = launch_ledger.default_ledger()

    cont_batch = None
    if plan.cont_batch:
        from ..crypto.bls import scheduler as bls_scheduler

        sched = bls_scheduler.default_scheduler()
        sched.drain()
        # machine-checked scheduler invariants from the admission audit:
        # speculation never launches ahead of queued validator-lane work,
        # and every launch admitted in (priority, deadline) order
        for i, rec in enumerate(sched.launch_log):
            if "speculative" in rec["lanes"] and rec["real_queued_before"]:
                failures.append(
                    f"launch {i} admitted speculation ahead of "
                    f"{rec['real_queued_before']} queued validator-lane "
                    "batches"
                )
            if list(rec["keys"]) != sorted(rec["keys"]):
                failures.append(
                    f"launch {i} broke deadline admission order: "
                    f"{rec['keys']}"
                )
        # the ledger is the EXPORTED surface for the same admissions: every
        # logged launch must have a matching "sched" record carrying the
        # lanes and the speculative_withheld / requeue accounting that
        # previously lived only in the in-process launch_log
        sched_recs = [r for r in led.records() if r.kind == "sched"]
        if len(sched_recs) != len(sched.launch_log):
            failures.append(
                f"ledger lost launches: {len(sched_recs)} sched records "
                f"vs {len(sched.launch_log)} logged launches"
            )
        else:
            for i, (rec, logged) in enumerate(
                zip(sched_recs, sched.launch_log)
            ):
                if tuple(rec.lanes or ()) != tuple(logged["lanes"]):
                    failures.append(
                        f"ledger launch {i} lane mix diverged from the "
                        f"audit log: {rec.lanes} vs {logged['lanes']}"
                    )
                if (rec.speculative_withheld or 0) != logged[
                    "speculative_withheld"
                ]:
                    failures.append(
                        f"ledger launch {i} dropped the "
                        "speculative_withheld count: "
                        f"{rec.speculative_withheld} vs "
                        f"{logged['speculative_withheld']}"
                    )
        withheld_total = sum(
            r.speculative_withheld or 0 for r in sched_recs
        )
        if withheld_total != sched.stats["preemptions"]:
            failures.append(
                "ledger speculative_withheld total "
                f"{withheld_total} != scheduler preemptions "
                f"{sched.stats['preemptions']}"
            )
        cont_batch = dict(sched.stats)
        padded = cont_batch["pad_sets"] + cont_batch["real_sets"]
        cont_batch["pad_waste_ratio"] = (
            round(cont_batch["pad_sets"] / padded, 4) if padded else 0.0
        )
        cont_batch["launches_logged"] = len(sched.launch_log)

    from ..utils.monitoring import ledger_health_fields

    trace = tracer.dump_json()
    ledger_dump = led.dump_json()
    health = trace_health_fields()
    health["ledger"] = ledger_health_fields(led)
    report = {
        "name": plan.name,
        "seed": plan.seed,
        "nodes": len(sim.nodes),
        "validators": plan.validator_count,
        "slots_run": slot,
        "final_heads": heads,
        "finalized_epoch": finalized,
        "invariants": {"checked_slots": checker.checked_slots},
        "crash_recoveries": crash_recoveries,
        "proposer_slashings_found": slashings,
        "attester_slashings_found": att_slashings,
        "byzantine_blocks_gossiped": len(sim.forged_roots)
        + len(sim.equivocation_roots),
        "byzantine": {
            "counts": dict(sim.byz_counts),
            "protection_overrides": sim.total_byz_overrides(),
            "aggregates_emitted": len(sim.byz_aggregate_roots),
        },
        "serving": serving_report,
        "transport": plan.transport,
        "speculation": speculation,
        "cont_batch": cont_batch,
        "slo": {
            "observed_delay_p95_s": observed_p95,
            "imported_delay_p95_s": imported_p95,
            "counter_deltas": deltas,
            "health": health,
            "failures": failures,
        },
        "fsck_issues": fsck_issues,
        "trace_events": len(tracer.finished_spans()),
        "trace_sha256": hashlib.sha256(trace.encode()).hexdigest(),
        "ledger_records": len(led.records()),
        "ledger_sha256": hashlib.sha256(ledger_dump.encode()).hexdigest(),
    }
    return ScenarioResult(report=report, trace=trace, ledger=ledger_dump)


class _ServingRig:
    """Serving-under-chaos composition: a REAL BeaconApiServer over node
    0's chain, hit with a seeded HTTP mix after every phase — while the
    phase's partitions/storms/faults are still installed — plus one live
    SSE subscriber. At scenario end it turns the serving SLOs into
    checks: the validator lane is never shed or failed, the cached
    head-root answer agrees with the chain's actual head after every
    reorg of the run, and head events were actually delivered over SSE.

    Serving plans must not crash or churn node 0: the tier is anchored
    on its chain object for the whole run (documented contract, same as
    a real deployment pinning its HTTP front-end to one process)."""

    READ_ROUTES = (
        "/eth/v1/beacon/states/head/root",
        "/eth/v1/beacon/headers/head",
        "/eth/v1/beacon/genesis",
        "/eth/v1/beacon/states/finalized/finality_checkpoints",
        "/eth/v1/node/version",
    )
    DEBUG_ROUTE = "/lighthouse/health"

    def __init__(self, sim):
        from ..http_api import BeaconApi, BeaconApiServer
        from ..validator_client import InProcessBeaconNode

        self.sim = sim
        self.chain = sim.nodes[0].chain
        self.server = BeaconApiServer(BeaconApi(InProcessBeaconNode(self.chain)))
        self.server.start()
        self.tier = self.server.serving
        self.base = f"http://127.0.0.1:{self.server.port}"
        self.sse = self.tier.broadcaster.subscribe(topics=("head",))
        self.requests = 0
        self.statuses: dict[int, int] = {}
        self.validator_failures: list[str] = []

    def _get(self, path: str) -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.base + path, timeout=30) as r:
                return int(r.status), r.read()
        except urllib.error.HTTPError as e:
            return int(e.code), e.read()
        except OSError as e:
            self.statuses[-1] = self.statuses.get(-1, 0) + 1
            return -1, str(e).encode()

    def replay(self, rng: random.Random, reads: int = 10) -> None:
        """One seeded traffic burst: a read-only mix, a debug-lane probe
        (sheddable), and a validator-duties request (NEVER sheddable —
        admission's structural immunity is asserted end-of-run)."""
        spe = self.sim.preset.slots_per_epoch
        epoch = int(self.chain.head_state.slot) // spe
        paths = [rng.choice(self.READ_ROUTES) for _ in range(reads)]
        paths.append(self.DEBUG_ROUTE)
        paths.append(f"/eth/v1/validator/duties/proposer/{epoch}")
        for path in paths:
            code, _ = self._get(path)
            self.requests += 1
            self.statuses[code] = self.statuses.get(code, 0) + 1
            if path.startswith("/eth/v1/validator/") and code != 200:
                self.validator_failures.append(f"{path} -> {code}")

    def report(self) -> dict:
        """End-of-run serving SLO checks (run while the server is still
        up, before stop())."""
        import json as _json

        failures: list[str] = []
        if self.validator_failures:
            failures.append(
                "validator lane degraded under chaos: "
                f"{self.validator_failures[:3]}"
            )
        # cache consistency after reorgs: two reads (second one from the
        # warm cache) must both name the chain's ACTUAL head. The probe
        # is the AUDIT, not traffic — admission pressure is windowed over
        # the whole chaotic run and would shed it, so zero the health
        # source for the duration (shed responses never consult the
        # cache, so a shed probe would prove nothing either way).
        actual = "0x" + bytes(self.chain.head_root).hex()
        admission = self.tier.admission
        saved_health = admission.health_source
        admission.health_source = lambda: {}
        try:
            for attempt in ("cold", "warm"):
                code, body = self._get("/eth/v1/beacon/blocks/head/root")
                served = None
                if code == 200:
                    served = _json.loads(body)["data"]["root"]
                if served != actual:
                    failures.append(
                        f"head-root cache inconsistent after reorg "
                        f"({attempt}): served {served} != chain {actual}"
                    )
        finally:
            admission.health_source = saved_health
        # SSE delivery: the run's head events must have reached the
        # subscriber (drain the buffer; drops still count as delivered
        # fan-out — the bound is the contract, silence is the failure)
        events = self.sse.dropped if self.sse is not None else 0
        while self.sse is not None:
            item = self.sse.pop(timeout=0)
            if item is None:
                break
            events += 1
        if events == 0:
            failures.append("no head events delivered over SSE")
        return {
            "requests": self.requests,
            "statuses": dict(sorted(self.statuses.items())),
            "sse_head_events": events,
            "admission": self.tier.admission.stats(),
            "cache": self.tier.cache.stats(),
            "failures": failures,
        }

    def stop(self) -> None:
        self.server.stop()


def _partition_by_sim_index(sim, groups) -> None:
    by_index = {
        getattr(n, "sim_index", i): n for i, n in enumerate(sim.nodes)
    }
    sim._partition = [
        [by_index[i] for i in g if i in by_index] for g in groups
    ]
    sim._partition = [g for g in sim._partition if g]
    sim.raw_bus.set_partitions(
        [[n.peer_id for n in g] for g in sim._partition]
    )


def assert_bit_identical_replay(plan: ScenarioPlan, device=None):
    """Run the plan twice; the two runs must agree on final heads AND
    export byte-identical traces and launch-ledger dumps (the bit-replay
    contract)."""
    r1 = run_scenario(plan, device=device)
    r2 = run_scenario(plan, device=device)
    assert r1.report["final_heads"] == r2.report["final_heads"], (
        "replay diverged: final heads differ"
    )
    assert r1.trace == r2.trace, "replay diverged: trace bytes differ"
    assert r1.ledger == r2.ledger, (
        "replay diverged: launch-ledger bytes differ"
    )
    return r1, r2


# -- the scenario catalogue (cli `scenario --name ...` + the test matrix) ----


def _spe() -> int:
    return MINIMAL.slots_per_epoch


def partition_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Split the network 50/50 for ~an epoch, heal, require finality."""
    spe = _spe()
    return ScenarioPlan(
        name="partition",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "split",
                slots=spe,
                partition=(
                    tuple(range(nodes // 2)),
                    tuple(range(nodes // 2, nodes)),
                ),
            ),
            Phase("heal", slots=3 * spe, heal=True),
        ),
        slo=SLO(
            finality_min_epoch=2,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def churn_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Nodes leave and fresh nodes join mid-run; leavers rejoin and
    everyone converges with sync catch-up."""
    spe = _spe()
    return ScenarioPlan(
        name="churn",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        phases=(
            Phase("baseline", slots=spe),
            Phase("churn", slots=spe, join_nodes=2, leave_nodes=(nodes - 1,)),
            Phase("rejoin", slots=2 * spe, rejoin_nodes=(nodes - 1,)),
        ),
        slo=SLO(
            finality_min_epoch=2,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def equivocation_storm_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """A Byzantine fraction double-proposes, forges invalid blocks, and
    double-votes; honest nodes must ignore/reject every artifact, keep
    finalizing, and the slashers must detect the proposer equivocation."""
    spe = _spe()
    return ScenarioPlan(
        name="equivocation-storm",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "storm",
                slots=2 * spe,
                equivocate_every=2,
                forge_every=4,
                conflicting_atts_every=4,
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            expect_proposer_slashings=True,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def long_nonfinality_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Withhold >1/3 of validators for multiple epochs (justification
    stalls, the hot DB grows), then recover: the finality jump drives the
    sub-batched migrate_to_freezer over a multi-epoch range, and every
    store must end fsck-clean including freezer decodability."""
    spe = _spe()
    return ScenarioPlan(
        name="long-nonfinality",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        # deliberately tiny windows: the multi-epoch finality jump MUST
        # commit through several journaled sub-batches
        migration_chunk_slots=spe,
        phases=(
            Phase("baseline", slots=spe),
            Phase("stall", slots=3 * spe, withhold_fraction=0.4),
            Phase("recovery", slots=4 * spe),
        ),
        slo=SLO(
            finality_min_epoch=5,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def crash_recovery_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """CrashPlan kills a node at the Nth store op mid-scenario; it
    reopens through WAL recovery, passes fsck (freezer decodability
    included), re-syncs, and the network converges."""
    spe = _spe()
    return ScenarioPlan(
        name="crash-recovery",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "crash",
                slots=2 * spe,
                crash_node=1,
                # tuned to land mid-batch so the reopen exercises a real
                # WAL replay, not a clean batch-boundary restart
                crash_after_ops=23,
                crash_action="after",
            ),
            Phase("settle", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def equivocation_storm_speculate_plan(
    seed=0, nodes=4, validators=64
) -> ScenarioPlan:
    """The equivocation storm with the duty-driven precompute subsystem
    attached to every node: the storm's reorgs must drive clean
    shuffling-key invalidation (never a stale-entry acceptance), the
    no-Byzantine-import invariant must hold exactly as without
    speculation, and the speculation counters must stay consistent."""
    import dataclasses

    return dataclasses.replace(
        equivocation_storm_plan(seed, nodes, validators),
        name="equivocation-storm-speculate",
        speculate=True,
    )


def partition_storm_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Combined phases: the network PARTITIONS in the middle of an
    ongoing equivocation storm (the storm keeps firing on both sides of
    the split), then heals with the storm still running, then recovers.
    The no-Byzantine-import invariant must hold on every side and the
    slashers must still detect the proposer equivocation."""
    spe = _spe()
    return ScenarioPlan(
        name="partition-storm",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        phases=(
            Phase("baseline", slots=spe),
            Phase("storm", slots=spe, equivocate_every=2, forge_every=4),
            Phase(
                "split-during-storm",
                slots=spe,
                partition=(
                    tuple(range(nodes // 2)),
                    tuple(range(nodes // 2, nodes)),
                ),
                equivocate_every=2,
                forge_every=4,
                conflicting_atts_every=4,
            ),
            Phase(
                "heal-during-storm",
                slots=2 * spe,
                heal=True,
                equivocate_every=3,
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            expect_proposer_slashings=True,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def crash_nonfinality_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Combined phases: a node crashes DURING long non-finality — the
    CrashPlan is re-armed mid-phase (crash_arm_at) while 40% of
    validators are withheld, so the WAL-recovery reopen happens against a
    swollen hot DB, and the eventual finality jump migrates through
    sub-batched freezer windows on a store that just replayed its
    journal."""
    spe = _spe()
    return ScenarioPlan(
        name="crash-nonfinality",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        migration_chunk_slots=spe,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "stall-crash",
                slots=3 * spe,
                withhold_fraction=0.4,
                crash_node=1,
                crash_after_ops=23,
                crash_action="after",
                # re-arm one epoch INTO the stall: the kill lands while
                # justification is already stuck
                crash_arm_at=spe,
            ),
            Phase("recovery", slots=4 * spe),
        ),
        slo=SLO(
            finality_min_epoch=5,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def churn_backfill_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Combined phases: fresh nodes join mid-storm and must backfill
    through range sync WHILE transport faults ramp up mid-phase
    (FaultPlan.set_rates via rates_at) — the retry/breaker budget is the
    SLO under test."""
    spe = _spe()
    return ScenarioPlan(
        name="churn-backfill",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        phases=(
            Phase("baseline", slots=2 * spe),
            Phase(
                "join-during-storm",
                slots=2 * spe,
                join_nodes=2,
                equivocate_every=3,
                error_rate=0.05,
                # ramp the fault plan mid-phase, then calm it before the
                # phase ends so recovery starts from a clean transport
                rates_at=((spe // 2, 0.15, 0.10), (spe + spe // 2, 0.0, 0.0)),
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            observed_delay_p95_s=6.0,
            max_retry_attempts=400,
            max_breaker_transitions=80,
            max_bisection_calls=100,
        ),
    )


def byzantine_vc_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Byzantine validator clients drive slashable duties through the
    REAL signing path: double proposals and conflicting aggregate votes
    in the first byz phase, surround votes plus equivocating aggregates
    once justification has advanced. Slashers must detect BOTH slashing
    families, speculation must never confirm a byz aggregate by lookup,
    and the chain must keep finalizing."""
    spe = _spe()
    return ScenarioPlan(
        name="byzantine-vc",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        speculate=True,
        phases=(
            Phase("baseline", slots=2 * spe),
            Phase(
                "byz-equivocate",
                slots=2 * spe,
                byz=ByzPlan(
                    fraction=0.25,
                    every=2,
                    double_propose=True,
                    conflicting_votes=True,
                ),
            ),
            # surround needs an earlier honest vote with source >= 1 from
            # the same validator, hence the second byz phase runs after
            # justification has advanced
            Phase(
                "byz-surround",
                slots=2 * spe,
                byz=ByzPlan(
                    fraction=0.25,
                    every=2,
                    double_propose=False,
                    conflicting_votes=False,
                    surround_votes=True,
                    equivocating_aggregates=True,
                ),
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=4,
            expect_proposer_slashings=True,
            expect_attester_slashings=True,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def serving_chaos_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Serving under chaos: node 0 fronts a real BeaconApiServer while
    the network splits and a storm runs; a seeded HTTP mix replays after
    every phase (mid-partition included) and the serving SLOs —
    validator-lane immunity, head-root cache consistency after the
    heal-reorg, SSE delivery — are end-of-run checks. Node 0 is never
    crashed or churned (the serving anchor contract)."""
    spe = _spe()
    return ScenarioPlan(
        name="serving-chaos",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        serving=True,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "split-storm",
                slots=spe,
                partition=(
                    tuple(range(nodes // 2)),
                    tuple(range(nodes // 2, nodes)),
                ),
                equivocate_every=2,
            ),
            Phase("heal", slots=3 * spe, heal=True),
        ),
        slo=SLO(
            finality_min_epoch=2,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def aggregation_soundness_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Aggregation-soundness probes under Byzantine pressure: a byz phase
    drives equivocating aggregates through the chain (the confirmed_roots
    audit watches the speculation seam), and at scenario end every
    forgery family — rogue-key attribution, RLC weight collisions,
    subgroup/small-order smuggling, grouping cancellation, speculation
    poisoning — runs against the real cpu oracle. One accepted probe is
    an InvariantViolation, shrinkable by the fuzzer like any safety
    finding."""
    spe = _spe()
    return ScenarioPlan(
        name="aggregation-soundness",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        attach_slashers=True,
        speculate=True,
        aggregation_probes=(
            "rogue-key",
            "weight-collision",
            "subgroup",
            "grouping-cancellation",
            "speculation-poisoning",
        ),
        phases=(
            Phase("baseline", slots=2 * spe),
            Phase(
                "byz-aggregates",
                slots=2 * spe,
                byz=ByzPlan(
                    fraction=0.25,
                    every=2,
                    conflicting_votes=True,
                    equivocating_aggregates=True,
                ),
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            expect_attester_slashings=True,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


def bursty_traffic_plan(seed=0, nodes=4, validators=64) -> ScenarioPlan:
    """Bursty traffic through the continuous-batching scheduler: the
    full gossip mix (attestations, aggregates, sync messages, blocks)
    arrives in slot-boundary bursts while speculation keeps the device
    busy between them, and a node crashes mid-storm. The scheduler's
    launch audit log is machine-checked at the end of the run: no
    launch ever admitted a speculative batch while validator-lane work
    was queued, and every launch admitted its members in
    (priority, deadline) order — including the launches that straddle
    the crash. Replay must stay bit-identical with the scheduler on."""
    spe = _spe()
    return ScenarioPlan(
        name="bursty-traffic",
        seed=seed,
        node_count=nodes,
        validator_count=validators,
        speculate=True,
        cont_batch=True,
        phases=(
            Phase("baseline", slots=spe),
            Phase(
                "burst-storm",
                slots=2 * spe,
                equivocate_every=3,
                conflicting_atts_every=4,
            ),
            Phase(
                "burst-crash",
                slots=2 * spe,
                equivocate_every=3,
                crash_node=1,
                crash_after_ops=23,
                crash_action="after",
            ),
            Phase("recovery", slots=2 * spe),
        ),
        slo=SLO(
            finality_min_epoch=3,
            observed_delay_p95_s=6.0,
            max_retry_attempts=100,
            max_breaker_transitions=50,
            max_bisection_calls=100,
        ),
    )


PLANS = {
    "partition": partition_plan,
    "churn": churn_plan,
    "equivocation-storm": equivocation_storm_plan,
    "equivocation-storm-speculate": equivocation_storm_speculate_plan,
    "long-nonfinality": long_nonfinality_plan,
    "crash-recovery": crash_recovery_plan,
    "partition-storm": partition_storm_plan,
    "crash-nonfinality": crash_nonfinality_plan,
    "churn-backfill": churn_backfill_plan,
    "byzantine-vc": byzantine_vc_plan,
    "serving-chaos": serving_chaos_plan,
    "aggregation-soundness": aggregation_soundness_plan,
    "bursty-traffic": bursty_traffic_plan,
}
