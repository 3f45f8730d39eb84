"""Seeded scenario-plan fuzzing with the invariant checker as oracle.

The scenario harness gives us exactly what a search procedure needs:
machine-checked SAFETY properties (`InvariantChecker`, fail-fast),
end-of-run SLO checks, and bit-identical replay from a single integer
seed. This module closes the loop: `generate_plan` draws a random — but
fully seeded — `ScenarioPlan` from a typed grammar (`PlanGrammar`),
`evaluate` runs it under the oracle, and `shrink` greedily minimizes any
failing plan to a smallest-still-failing reproducer that is persisted to
`tests/fuzz_corpus/` and replayed deterministically in tier-1.

Because a correct harness on a correct node SHOULD find nothing, the
shrinking pipeline is validated with PLANTED oracle bugs (`PLANTS`):
test-only report predicates that misclassify a benign report field as a
violation (e.g. "any emitted Byzantine artifact counts as an import").
A plant gives the fuzzer a deterministic needle whose minimal reproducer
is known by construction, so the generator/shrinker/corpus machinery is
itself under test — the acceptance loop the paper's verification framing
calls "properties as the oracle".

Corpus entries are JSON: the full plan, the plant (if any), and the
failure reason. Tier-1 replay asserts BOTH directions: under the
recorded plant the plan still fails with the recorded reason, and
without the plant it passes clean — a corpus entry is a pinned
(bug, reproducer) pair, not a permanently red test.

Everything here is seed-driven (`random.Random(seed)`); there is no
wall-clock anywhere in this module — iteration budgets live with the
caller.

The port's copy of lighthouse_tpu/harness/fuzz.py. The port's own
addition: the `device` keyword of `evaluate`, `fuzz`, `shrink`,
`replay_corpus_entry` and `fuzz_and_shrink`, passed on to `run_scenario`
(None is the card, "cpu" only when asked); plans, plants and corpus JSON
are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import random
from dataclasses import dataclass

from ..types import MINIMAL
from ..validator_client.byzantine import ByzPlan
from .scenario import (
    SLO,
    InvariantViolation,
    Phase,
    ScenarioPlan,
    run_scenario,
)

# -- planted oracle bugs (shrinker validation; test-only) ---------------------

# Each plant is a predicate over a PASSING run's report that deliberately
# misreads a benign field as a violation. Plants must be monotone in the
# plan's adversarial content (more chaos never un-fires them) so greedy
# shrinking converges to the single phase that triggers them.
PLANTS = {
    # "any emitted storm artifact was imported": fires for any plan with
    # an equivocation/forge storm phase; minimal repro is one storm phase
    "byz-gossip-imported": lambda report: (
        report["byzantine_blocks_gossiped"] > 0
    ),
    # "any slashing-protection override is a leak": fires for any plan
    # with a byz validator-client phase that produced slashable signing
    "protection-override-leak": lambda report: (
        report["byzantine"]["protection_overrides"] > 0
    ),
}


# -- the typed grammar --------------------------------------------------------


@dataclass(frozen=True)
class PlanGrammar:
    """Bounds for plan generation. Knob ranges are chosen so a correct
    stack always converges: withholding stays under 1/3, fault rates stay
    retryable, and every plan ends with a heal + settle tail."""

    max_adversarial_phases: int = 3
    node_counts: tuple = (3, 4)
    validator_count: int = 64
    phase_kinds: tuple = (
        "calm",
        "partition",
        "withhold",
        "storm",
        "churn",
        "faults",
        "byz",
        "crash",
    )
    max_withhold: float = 0.3
    max_fault_rate: float = 0.15
    max_byz_fraction: float = 0.3
    settle_epochs: int = 4
    speculate_probability: float = 0.25
    # serving/wire/scale riders: a drawn plan can front the real HTTP
    # API on node 0 and/or run over the real wire transport — the same
    # bounds-typed, fully seeded draw as every other knob
    serving_probability: float = 0.15
    wire_probability: float = 0.1
    # aggregation-soundness probe families (crypto/bls/adversary.py)
    # attached to the plan's end-of-run audit: any accepted forgery is
    # an InvariantViolation finding, so the shrinker minimizes soundness
    # regressions like any other safety bug
    probe_probability: float = 0.25
    probe_families: tuple = (
        "rogue-key",
        "weight-collision",
        "subgroup",
        "grouping-cancellation",
        "speculation-poisoning",
    )


# Named grammars for the CLI (--grammar): "adversary" pins the
# aggregation-soundness probe rider to every plan and biases toward the
# speculation/byz surface those probes audit.
GRAMMARS = {
    "default": PlanGrammar(),
    "adversary": PlanGrammar(
        probe_probability=1.0,
        speculate_probability=0.5,
        phase_kinds=("calm", "storm", "byz", "partition", "withhold"),
    ),
}


def _gen_phase(kind: str, i: int, rng: random.Random, g: PlanGrammar, nodes: int) -> Phase:
    spe = MINIMAL.slots_per_epoch
    slots = rng.randint(max(2, spe // 2), 2 * spe)
    name = f"{kind}-{i}"
    if kind == "partition":
        return Phase(
            name,
            slots=slots,
            partition=(
                tuple(range(nodes // 2)),
                tuple(range(nodes // 2, nodes)),
            ),
        )
    if kind == "withhold":
        return Phase(
            name,
            slots=slots,
            withhold_fraction=round(rng.uniform(0.1, g.max_withhold), 3),
        )
    if kind == "storm":
        return Phase(
            name,
            slots=slots,
            equivocate_every=rng.choice((2, 3)),
            forge_every=rng.choice((0, 4)),
            conflicting_atts_every=rng.choice((0, 4)),
        )
    if kind == "churn":
        return Phase(name, slots=slots, join_nodes=1)
    if kind == "faults":
        rates_at = ()
        if rng.random() < 0.5:
            # mid-phase re-rating: spike then calm before the phase ends
            rates_at = (
                (slots // 2, round(rng.uniform(0.0, g.max_fault_rate), 3), 0.0),
            )
        return Phase(
            name,
            slots=slots,
            error_rate=round(rng.uniform(0.0, g.max_fault_rate), 3),
            delay_rate=round(rng.uniform(0.0, g.max_fault_rate), 3),
            rates_at=rates_at,
        )
    if kind == "byz":
        behaviors = {
            "double_propose": rng.random() < 0.7,
            "conflicting_votes": rng.random() < 0.5,
            "equivocating_aggregates": rng.random() < 0.3,
        }
        if not any(behaviors.values()):
            behaviors["double_propose"] = True
        return Phase(
            name,
            slots=slots,
            byz=ByzPlan(
                fraction=round(rng.uniform(0.1, g.max_byz_fraction), 3),
                every=rng.randint(1, 3),
                surround_votes=False,
                **behaviors,
            ),
        )
    if kind == "crash":
        return Phase(
            name,
            slots=max(slots, spe),
            crash_node=1,
            crash_after_ops=rng.randint(15, 40),
            crash_action="after",
            crash_arm_at=rng.choice((None, 2)),
        )
    return Phase(name, slots=slots)  # calm


def generate_plan(seed: int, grammar: PlanGrammar | None = None) -> ScenarioPlan:
    """A random-but-seeded plan: baseline, 1..N adversarial phases, and
    a heal+settle tail long enough that a correct stack re-finalizes."""
    g = grammar or PlanGrammar()
    rng = random.Random(seed)
    spe = MINIMAL.slots_per_epoch
    nodes = rng.choice(g.node_counts)
    phases = [Phase("baseline", slots=spe)]
    kinds = [
        rng.choice(g.phase_kinds)
        for _ in range(rng.randint(1, g.max_adversarial_phases))
    ]
    for i, kind in enumerate(kinds):
        phases.append(_gen_phase(kind, i, rng, g, nodes))
    phases.append(Phase("settle", slots=g.settle_epochs * spe, heal=True))
    needs_slashers = any(
        p.equivocate_every or p.conflicting_atts_every or p.byz is not None
        for p in phases
    )
    # rider draws happen UNCONDITIONALLY and in a fixed order so each
    # knob consumes the same rng stream position regardless of the
    # others' outcomes (same seed -> same plan, knob by knob)
    speculate = rng.random() < g.speculate_probability
    serving = rng.random() < g.serving_probability
    transport = "wire" if rng.random() < g.wire_probability else "memory"
    probes: tuple = ()
    if rng.random() < g.probe_probability:
        probes = tuple(
            sorted(
                rng.sample(
                    g.probe_families,
                    rng.randint(1, len(g.probe_families)),
                )
            )
        )
    return ScenarioPlan(
        name=f"fuzz-{seed}",
        seed=seed,
        node_count=nodes,
        validator_count=g.validator_count,
        phases=tuple(phases),
        attach_slashers=needs_slashers,
        speculate=speculate,
        serving=serving,
        transport=transport,
        aggregation_probes=probes,
        slo=SLO(finality_min_epoch=1, heads_converge=True),
    )


# -- the oracle ---------------------------------------------------------------


def evaluate(
    plan: ScenarioPlan, plant: str | None = None, device=None
) -> str | None:
    """Run the plan under the oracle; None == clean, else a failure
    reason. Safety invariants raise inside the run (fail-fast), SLO
    failures surface from the report, and an optional plant predicate is
    applied last (it only fires on otherwise-clean runs, which is what
    makes its minimal reproducer stable)."""
    try:
        result = run_scenario(plan, device=device)
    except InvariantViolation as e:
        return f"invariant: {e}"
    failures = result.report["slo"]["failures"]
    if failures:
        return f"slo: {failures[0]}"
    if plant is not None and PLANTS[plant](result.report):
        return f"plant[{plant}]: predicate fired"
    return None


def fuzz(
    start_seed: int,
    iterations: int,
    grammar: PlanGrammar | None = None,
    plant: str | None = None,
    device=None,
) -> list[tuple[ScenarioPlan, str]]:
    """`iterations` seeded generate+evaluate rounds; returns the failing
    (plan, reason) pairs. Purely seed-driven — a given (start_seed,
    iterations, grammar, plant) always explores the same plans."""
    findings = []
    for i in range(iterations):
        plan = generate_plan(start_seed + i, grammar)
        reason = evaluate(plan, plant, device=device)
        if reason is not None:
            findings.append((plan, reason))
    return findings


# -- shrinking ----------------------------------------------------------------


def _phase_reset_candidates(plan: ScenarioPlan, pi: int):
    """Per-field resets toward the Phase defaults (drop one knob at a
    time), then a slots halving — the knob ordering makes the walk
    deterministic."""
    phase = plan.phases[pi]
    defaults = Phase(name=phase.name, slots=phase.slots)
    for f in dataclasses.fields(Phase):
        if f.name in ("name", "slots"):
            continue
        if getattr(phase, f.name) != getattr(defaults, f.name):
            new_phase = dataclasses.replace(
                phase, **{f.name: getattr(defaults, f.name)}
            )
            yield _with_phase(plan, pi, new_phase)
    if phase.slots > 2:
        yield _with_phase(
            plan, pi, dataclasses.replace(phase, slots=max(2, phase.slots // 2))
        )


def _with_phase(plan: ScenarioPlan, pi: int, phase: Phase) -> ScenarioPlan:
    phases = list(plan.phases)
    phases[pi] = phase
    return dataclasses.replace(plan, phases=tuple(phases))


def _shrink_candidates(plan: ScenarioPlan):
    # 1) drop whole phases (front to back; keep at least one)
    if len(plan.phases) > 1:
        for pi in range(len(plan.phases)):
            phases = plan.phases[:pi] + plan.phases[pi + 1 :]
            yield dataclasses.replace(plan, phases=phases)
    # 2) shrink node count toward 3
    if plan.node_count > 3:
        yield dataclasses.replace(plan, node_count=plan.node_count - 1)
    # 3) drop subsystem riders
    if plan.aggregation_probes:
        # one family at a time first (pin WHICH family regressed), then
        # the whole probe rider
        if len(plan.aggregation_probes) > 1:
            for fi in range(len(plan.aggregation_probes)):
                yield dataclasses.replace(
                    plan,
                    aggregation_probes=(
                        plan.aggregation_probes[:fi]
                        + plan.aggregation_probes[fi + 1 :]
                    ),
                )
        yield dataclasses.replace(plan, aggregation_probes=())
    if plan.serving:
        yield dataclasses.replace(plan, serving=False)
    if plan.transport != "memory":
        yield dataclasses.replace(plan, transport="memory")
    if plan.speculate:
        yield dataclasses.replace(plan, speculate=False)
    # 4) per-phase knob resets + slot halving
    for pi in range(len(plan.phases)):
        yield from _phase_reset_candidates(plan, pi)


def shrink(
    plan: ScenarioPlan,
    failing,
    max_attempts: int = 80,
    device=None,
) -> tuple[ScenarioPlan, str]:
    """Greedy first-improvement minimization: repeatedly take the first
    candidate simplification that STILL fails THE SAME WAY, until a full
    pass yields none (or the attempt budget is spent). `failing(plan)`
    returns the reason string or None; `plan` must fail on entry.

    Candidates are only accepted when their failure CATEGORY (the reason
    prefix before the first colon: "invariant"/"slo"/"plant[...]")
    matches the original — without that pin, greedy shrinking wanders:
    dropping phases from a plant-failing plan eventually produces a
    2-slot plan that fails the finality SLO instead, which is a smaller
    plan but a reproducer for a different (and vacuous) failure.
    Deterministic: candidate order is fixed, so the same input always
    minimizes to the same reproducer. A `device` other than None is
    passed on to every call as `failing(plan, device=device)`."""
    if device is not None:
        failing = functools.partial(failing, device=device)
    reason = failing(plan)
    if reason is None:
        raise ValueError("shrink() called with a passing plan")
    category = reason.split(":", 1)[0]
    attempts = 0
    improved = True
    while improved and attempts < max_attempts:
        improved = False
        for cand in _shrink_candidates(plan):
            attempts += 1
            r = failing(cand)
            if r is not None and r.split(":", 1)[0] == category:
                plan, reason = cand, r
                improved = True
                break
            if attempts >= max_attempts:
                break
    return plan, reason


# -- corpus persistence -------------------------------------------------------


def plan_to_dict(plan: ScenarioPlan) -> dict:
    return dataclasses.asdict(plan)


def plan_from_dict(d: dict) -> ScenarioPlan:
    d = dict(d)
    phases = []
    for pd in d.pop("phases"):
        pd = dict(pd)
        byz = pd.pop("byz", None)
        pd["byz"] = ByzPlan(**byz) if byz else None
        if pd.get("partition") is not None:
            pd["partition"] = tuple(tuple(g) for g in pd["partition"])
        for tup_field in ("rates_at", "leave_nodes", "rejoin_nodes"):
            pd[tup_field] = tuple(
                tuple(x) if isinstance(x, list) else x
                for x in pd.get(tup_field, ())
            )
        phases.append(Phase(**pd))
    slo = SLO(**d.pop("slo"))
    if "aggregation_probes" in d:
        d["aggregation_probes"] = tuple(d["aggregation_probes"])
    return ScenarioPlan(phases=tuple(phases), slo=slo, **d)


def save_corpus_entry(path, plan: ScenarioPlan, reason: str, plant: str | None):
    """Write a minimized reproducer as a corpus JSON file."""
    entry = {
        "plan": plan_to_dict(plan),
        "plant": plant,
        "reason": reason,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entry, f, indent=1, sort_keys=True)
        f.write("\n")


def load_corpus_entry(path) -> dict:
    with open(path, encoding="utf-8") as f:
        entry = json.load(f)
    entry["plan"] = plan_from_dict(entry["plan"])
    return entry


def replay_corpus_entry(entry: dict, device=None) -> None:
    """The tier-1 contract for a corpus entry: under the recorded plant
    the plan must still fail with the recorded reason (the reproducer
    reproduces), and without the plant it must pass clean (the pinned
    bug was in the oracle plant, not the stack). Raises AssertionError
    on either direction."""
    plan = entry["plan"]
    reason = evaluate(plan, plant=entry["plant"], device=device)
    if reason != entry["reason"]:
        raise AssertionError(
            f"corpus entry did not reproduce: recorded {entry['reason']!r}, "
            f"got {reason!r}"
        )
    if entry["plant"] is not None:
        clean = evaluate(plan, plant=None, device=device)
        if clean is not None:
            raise AssertionError(
                f"corpus plan fails even without its plant: {clean}"
            )


def fuzz_and_shrink(
    start_seed: int,
    iterations: int,
    grammar: PlanGrammar | None = None,
    plant: str | None = None,
    device=None,
) -> list[tuple[ScenarioPlan, str]]:
    """The full loop: fuzz for findings, shrink each to its minimal
    reproducer. Returns minimized (plan, reason) pairs."""
    out = []
    for plan, _ in fuzz(start_seed, iterations, grammar, plant, device=device):
        out.append(shrink(plan, lambda p: evaluate(p, plant, device=device)))
    return out
