"""The port's plan fuzzer (lighthouse_tpu_torch/harness/fuzz.py) against
the JAX package's: `generate_plan` gives the same plan dict for seeds
0-63 under the default and the adversary grammar, and the grammars and
plants are the same; every corpus entry of tests/fuzz_corpus/ loads to
the same dict in both packages and round-trips through `plan_from_dict`;
the greedy shrinker walks to the same reproducer under the same synthetic
predicate, and passes `device` on; and the port's `replay_corpus_entry(
entry, device="cpu")` replays every corpus entry (its recorded reason
under its plant, clean without it), on the `fake` backend as in the JAX
package.

A shrink under a real plant runs a scenario for every candidate (minutes),
so it is not run here (ROADMAP Queue 1, step 5). No test here compiles an
XLA program."""

import dataclasses
import glob
import json
import os

import pytest

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.harness import fuzz as JF
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import fuzz as TF
from torch_port_util import no_xla_compile, scenario_sandbox

CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fuzz_corpus", "*.json")))


@pytest.fixture(autouse=True)
def _sandbox(monkeypatch):
    scenario_sandbox(monkeypatch)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield


@pytest.mark.parametrize("grammar", ["default", "adversary"])
def test_generate_plan_same_dicts_for_seeds_0_to_63(grammar):
    jg, tg = JF.GRAMMARS[grammar], TF.GRAMMARS[grammar]
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    for seed in range(64):
        want = JF.plan_to_dict(JF.generate_plan(seed, jg))
        got = TF.plan_to_dict(TF.generate_plan(seed, tg))
        assert got == want, seed
        assert TF.plan_from_dict(got) == TF.generate_plan(seed, tg)
    assert sorted(TF.PLANTS) == sorted(JF.PLANTS)


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_corpus_entry_loads_to_the_same_dict(path):
    want, got = JF.load_corpus_entry(path), TF.load_corpus_entry(path)
    assert TF.plan_to_dict(got["plan"]) == JF.plan_to_dict(want["plan"])
    assert (got["plant"], got["reason"]) == (want["plant"], want["reason"])
    assert got["plant"] in TF.PLANTS
    # the round trip through JSON gives the plan back, with every field
    # the file holds as it holds it (an older entry lacks the later riders,
    # which load as their defaults)
    wire = json.loads(json.dumps(TF.plan_to_dict(got["plan"])))
    assert TF.plan_from_dict(wire) == got["plan"]
    with open(path, encoding="utf-8") as f:
        filed = json.load(f)["plan"]
    assert {k: wire[k] for k in filed} == filed


def _storm_fails(plan, device="unset"):
    if any(p.equivocate_every for p in plan.phases):
        return "plant[synthetic]: storm present"
    return None


@pytest.mark.parametrize("seed", [11, 17])
def test_shrink_walks_to_the_same_reproducer(seed):
    """tests/test_fuzz.py's synthetic predicate over the plan: both
    shrinkers take the same walk to the same minimal plan; with a device
    the port's hands it to every call of the predicate."""
    stormy = next(s for s in range(seed, seed + 64)
                  if any(p.equivocate_every for p in JF.generate_plan(s).phases))
    want = JF.shrink(JF.generate_plan(stormy), _storm_fails, max_attempts=400)
    got = TF.shrink(TF.generate_plan(stormy), _storm_fails, max_attempts=400)
    assert (TF.plan_to_dict(got[0]), got[1]) == (JF.plan_to_dict(want[0]), want[1])
    devices = []

    def failing(p, device="unset"):
        devices.append(device)
        return _storm_fails(p)

    again = TF.shrink(TF.generate_plan(stormy), failing, max_attempts=400, device="cpu")
    assert again == got
    assert devices and set(devices) == {"cpu"}


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_port_replays_corpus_entry(path):
    entry = TF.load_corpus_entry(path)
    tapi.set_backend("torch_cuda", device="cpu")
    TF.replay_corpus_entry(entry, device="cpu")
    assert (tapi.get_backend_name(), tapi._DEVICE) == ("torch_cuda", "cpu")
