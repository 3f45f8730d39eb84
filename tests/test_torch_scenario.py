"""The port's scenario harness (lighthouse_tpu_torch/harness/scenario.py)
against the JAX package's: the small partition plan of
tests/test_scenarios.py (3 nodes, 48 validators, an epoch split, a heal,
4 epochs of MINIMAL) through JAX `run_scenario(plan)` and the port's
`run_scenario(plan, device="cpu")` gives the same report, key for key (the
final heads, the finalized epoch, no SLO failure, no fsck issue, the
health block), the same trace bytes and the same launch-ledger bytes;
the port's `assert_bit_identical_replay`; the five InvariantChecker cases
of tests/test_scenarios.py, the same verdicts in both packages; and the
port-only `device` keyword: it reaches the Simulator, and whether
run_scenario returns or raises, the caller's backend name and device are
back. Both packages run the scenario on the `fake` backend, by design.

The JAX side takes its interop public keys from the port's bytes
(`jax_keys_from_port`; the JAX host oracle would spend ~0.36 s a key). No
test here compiles an XLA program."""

import dataclasses
import os
from types import SimpleNamespace

import pytest

from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import scenario as JS
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import scenario as TS
from lighthouse_tpu_torch.network import simulator as TSIM
from lighthouse_tpu_torch.types import MINIMAL
from torch_port_util import jax_keys_from_port, no_xla_compile, scenario_sandbox

SPE = MINIMAL.slots_per_epoch


@pytest.fixture(autouse=True)
def _sandbox(monkeypatch):
    scenario_sandbox(monkeypatch)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield


def small_partition_plan(S, seed: int = 0):
    """tests/test_scenarios.py's tier-1 plan, built from package `S`."""
    return S.ScenarioPlan(
        name="partition-small",
        seed=seed,
        node_count=3,
        validator_count=48,
        phases=(
            S.Phase("baseline", slots=SPE),
            S.Phase("split", slots=SPE, partition=((0,), (1, 2))),
            S.Phase("heal", slots=2 * SPE, heal=True),
        ),
        slo=S.SLO(finality_min_epoch=1),
    )


def test_small_partition_same_report_trace_and_ledger(monkeypatch):
    """The whole report, the trace and the ledger equal across the
    packages: no field is excepted (none names its package). The port's
    caller had torch_cuda on "cpu": it has it back."""
    jax_keys_from_port(monkeypatch)
    monkeypatch.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
    want = JS.run_scenario(small_partition_plan(JS))
    tapi.set_backend("torch_cuda", device="cpu")
    got = TS.run_scenario(small_partition_plan(TS), device="cpu")
    assert (tapi.get_backend_name(), tapi._DEVICE) == ("torch_cuda", "cpu")
    assert japi.get_backend_name() == "fake"
    report = got.report
    assert report["slo"]["failures"] == []
    assert report["fsck_issues"] == {}
    assert report["finalized_epoch"] >= 1
    assert len(report["final_heads"]) == 1
    assert report["final_heads"] == want.report["final_heads"]
    assert report["finalized_epoch"] == want.report["finalized_epoch"]
    assert report["slo"]["health"] == want.report["slo"]["health"]
    assert report == want.report
    assert got.trace == want.trace
    assert got.ledger == want.ledger
    assert report["trace_events"] > 0 and report["ledger_records"] > 0


def test_port_small_partition_bit_identical_replay():
    r1, r2 = TS.assert_bit_identical_replay(small_partition_plan(TS), device="cpu")
    assert r1.report == r2.report
    assert r1.report["slo"]["failures"] == []


# -- the InvariantChecker cases of tests/test_scenarios.py ---------------------


def _node(peer, fe, fr, head_slot=10_000, states=()):
    genesis = b"\x01" * 32
    return SimpleNamespace(
        peer_id=peer,
        chain=SimpleNamespace(
            finalized_checkpoint=(fe, fr),
            head_state=SimpleNamespace(slot=head_slot),
            head_root=b"\x02" * 32,
            genesis_block_root=genesis if fr == b"" else fr,
            _states=set(states),
        ),
    )


def _sim(nodes):
    return SimpleNamespace(preset=MINIMAL, nodes=nodes, forged_roots=[],
                           equivocation_roots=[])


def _conflicting(S):
    checker = S.InvariantChecker(_sim([_node("a", 2, b"\xaa" * 32),
                                       _node("b", 2, b"\xbb" * 32)]))
    checker.check_slot(17)


def _regression(S):
    n = _node("a", 2, b"\xaa" * 32)
    checker = S.InvariantChecker(_sim([n]))
    checker.check_slot(17)
    n.chain.finalized_checkpoint = (1, b"\xaa" * 32)
    checker.check_slot(18)


def _restart(S):
    n = _node("a", 2, b"\xaa" * 32)
    checker = S.InvariantChecker(_sim([n]))
    checker.check_slot(17)
    n.chain.finalized_checkpoint = (1, b"\xaa" * 32)
    checker.note_restart(n)
    checker.check_slot(18)
    return checker.checked_slots


def _head_below(S):
    S.InvariantChecker(_sim([_node("a", 3, b"\xaa" * 32, head_slot=2)])).check_slot(30)


def _byzantine(S):
    bad = b"\x66" * 32
    sim = _sim([_node("a", 0, b"", states=(bad,))])
    sim.forged_roots.append(bad)
    S.InvariantChecker(sim).check_slot(5)


CHECKER_CASES = {
    "conflicting-finalized": (_conflicting, "CONFLICTING"),
    "finality-regression": (_regression, "regressed"),
    "restart-resets-floor": (_restart, None),
    "head-below-finalized": (_head_below, "below finalized"),
    "byzantine-import": (_byzantine, "Byzantine"),
}


def _verdict(S, case):
    try:
        return ("ok", case(S))
    except S.InvariantViolation as e:
        return ("violation", str(e))


@pytest.mark.parametrize("name", sorted(CHECKER_CASES))
def test_invariant_checker_same_verdicts(name):
    case, match = CHECKER_CASES[name]
    want, got = _verdict(JS, case), _verdict(TS, case)
    assert got == want
    if match is None:
        assert got == ("ok", 2)
    else:
        assert got[0] == "violation" and match in got[1]


# -- the port's device keyword -------------------------------------------------


class _Stop(Exception):
    pass


@pytest.mark.parametrize("how", ["simulator", "unknown-transport", "invariant"])
def test_backend_and_device_restored_when_the_run_raises(monkeypatch, how):
    """A spy Simulator sees the device the caller passed (None, the card,
    by default) and stops the run; a plan with an unknown transport raises
    before any Simulator; an InvariantViolation from the drive loop
    propagates. Each time the caller's backend and device are back, and
    LIGHTHOUSE_TPU_CONT_BATCH is scoped as in the JAX package."""
    seen = []

    class Spy:
        def __init__(self, *args, device="unset", **kwargs):
            seen.append(device)
            if how == "simulator":
                raise _Stop

    def drive(*args, **kwargs):
        raise TS.InvariantViolation("planted")

    monkeypatch.setattr(TSIM, "Simulator", Spy)
    monkeypatch.setattr(TS, "_drive_plan", drive)
    monkeypatch.delenv("LIGHTHOUSE_TPU_CONT_BATCH", raising=False)
    plan = dataclasses.replace(small_partition_plan(TS), cont_batch=True)
    if how == "unknown-transport":
        plan = dataclasses.replace(plan, transport="carrier-pigeon")
    raises = {"simulator": _Stop, "unknown-transport": ValueError,
              "invariant": TS.InvariantViolation}[how]
    for device in ("cpu", None):
        tapi.set_backend("torch_cuda", device="cpu")
        with pytest.raises(raises):
            TS.run_scenario(plan, device=device) if device else TS.run_scenario(plan)
        assert (tapi.get_backend_name(), tapi._DEVICE) == ("torch_cuda", "cpu")
        assert "LIGHTHOUSE_TPU_CONT_BATCH" not in os.environ
    assert seen == ([] if how == "unknown-transport" else ["cpu", None])
