"""The port's snappy block format and EF-vector walker
(lighthouse_tpu_torch/network/snappy.py, ef_tests.py) against the JAX
package's on the CPU:

- `compress` gives the JAX bytes on seeded inputs (empty, one byte,
  incompressible, repetitive, long runs, mixed), `decompress` round-trips
  both packages' output, and malformed streams raise the same errors;
- `run_tree` over one small tree in the official layout, written with
  the port's harness (16 validators, MINIMAL): one or two cases for
  every runner of `_RUNNERS`, the BLS cases of chip_smoke.py's writer
  and its genesis cases; both walkers give the same (path, ok, message)
  list on their `fake` backends, and every case but the BLS ones whose
  verdict the `fake` backend cannot give is ok;
- two BLS cases (an aggregate and a batch with one invalid set) on both
  packages' `cpu` backends: both ok, the same list.

The JAX side decompresses the cases' keys without the subgroup check
(~0.18 s a key otherwise), an infinity key still refused. No XLA
compile."""

import importlib.util
import json
import os
import random
import shutil
from pathlib import Path

import pytest

from lighthouse_tpu import ef_tests as JE
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.network import snappy as JS
from lighthouse_tpu_torch import ef_tests as TE
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.harness import StateHarness
from lighthouse_tpu_torch.network import snappy as TS
from lighthouse_tpu_torch.ssz import merkle_proof as TMP
from lighthouse_tpu_torch.state_transition import clone_state, process_slots
from lighthouse_tpu_torch.state_transition import per_epoch as TPE
from lighthouse_tpu_torch.state_transition.upgrades import upgrade_to_altair
from lighthouse_tpu_torch.utils.shuffle import compute_shuffled_index
from torch_port_util import jax_keys_decompressed, no_xla_compile

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

C = CS.consensus_modules()
MIN = T.MINIMAL
SLOTS = MIN.slots_per_epoch
N = 16


@pytest.fixture(autouse=True)
def _backends():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _inputs():
    rng = random.Random(12)
    noise = bytes(rng.getrandbits(8) for _ in range(3000))
    words = b" ".join(rng.choice([b"attestation", b"block", b"slot", b"root"])
                      for _ in range(900))
    return {
        "empty": b"", "one": b"\x07", "incompressible": noise,
        "repetitive": b"\xab\xcd" * 5000, "zeros": bytes(70000),
        "words": words, "mixed": noise[:500] + bytes(300) + words[:2000] + noise,
    }


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_snappy_compress_equals_jax_and_round_trips(name):
    raw = _inputs()[name]
    got = TS.compress(raw)
    assert got == JS.compress(raw)
    assert TS.decompress(got) == raw == JS.decompress(got)


@pytest.mark.parametrize("stream", [b"", b"\x80", b"\xff" * 6, b"\x05\x00ab",
                                    b"\x04\x0d\x01", b"\x03\x0a\x01\x00\x00"])
def test_snappy_malformed_streams_raise_as_jax(stream):
    def outcome(decompress):
        try:
            return "ok", decompress(stream)
        except ValueError as e:
            return "error", str(e)

    assert outcome(TS.decompress) == outcome(JS.decompress)


def _write(case, **files):
    CS._ef_write(str(case), {k.replace("__", "."): v for k, v in files.items()})


def _state_cases(base, host):
    """One or two cases of every state runner, from the port's harness."""
    spec = T.ChainSpec.minimal()
    h = StateHarness(N, MIN, spec, sign=False)
    g = h.state
    p0 = base / "minimal" / "phase0"
    # sanity/slots, sanity/blocks (valid, and a wrong proposer), random
    post = process_slots(clone_state(g), 2, MIN, spec)
    _write(p0 / "sanity/slots/pyspec_tests/slots_2", pre__ssz_snappy=g.as_ssz_bytes(),
           slots__yaml=2, post__ssz_snappy=post.as_ssz_bytes())
    signed, post = h.produce_block(1)
    for d in ("sanity/blocks/pyspec_tests/one_block", "random/random/pyspec_tests/r_0"):
        _write(p0 / d, pre__ssz_snappy=g.as_ssz_bytes(), meta__yaml={"blocks_count": 1},
               blocks_0__ssz_snappy=signed.as_ssz_bytes(),
               post__ssz_snappy=post.as_ssz_bytes())
    bad, _ = h.produce_block(1)
    bad.message.proposer_index = (bad.message.proposer_index + 1) % N
    _write(p0 / "sanity/blocks/pyspec_tests/wrong_proposer",
           pre__ssz_snappy=g.as_ssz_bytes(), meta__yaml={"blocks_count": 1},
           blocks_0__ssz_snappy=bad.as_ssz_bytes())
    # operations: a too-young exit (rejected); execution_payload before bellatrix
    young = process_slots(clone_state(g), SLOTS, MIN, spec)
    exit_op = T.SignedVoluntaryExit(message=T.VoluntaryExit(epoch=0, validator_index=3),
                                    signature=tapi.INFINITY_SIGNATURE)
    _write(p0 / "operations/voluntary_exit/pyspec_tests/too_young",
           pre__ssz_snappy=young.as_ssz_bytes(),
           voluntary_exit__ssz_snappy=exit_op.as_ssz_bytes())
    os.makedirs(p0 / "operations/execution_payload/pyspec_tests/before_bellatrix")
    # an attested epoch: epoch_processing and rewards on its last slot
    h.extend_chain(SLOTS - 1)
    boundary = clone_state(h.state)
    post = clone_state(boundary)
    TPE.run_epoch_sub_transition(post, "justification_and_finalization", MIN, spec)
    _write(p0 / "epoch_processing/justification_and_finalization/pyspec_tests/boundary",
           pre__ssz_snappy=boundary.as_ssz_bytes(), post__ssz_snappy=post.as_ssz_bytes())
    deltas = TE._deltas_container()
    comps = TPE.attestation_component_deltas(
        boundary, MIN, spec, {}, TPE._total_active_balance(boundary, MIN, spec))
    files = {f"{f}_deltas__ssz_snappy": deltas(rewards=comps[c][0], penalties=comps[c][1])
             .as_ssz_bytes() for f, c in (("source", "source"), ("target", "target"),
                                          ("head", "head"),
                                          ("inclusion_delay", "inclusion_delay"),
                                          ("inactivity_penalty", "inactivity"))}
    _write(p0 / "rewards/basic/pyspec_tests/attested", pre__ssz_snappy=boundary.as_ssz_bytes(),
           **files)
    # shuffling
    seed = bytes(range(32))
    _write(p0 / "shuffling/core/shuffle/shuffle_9", mapping__yaml={
        "seed": CS._hex(seed), "count": 9,
        "mapping": [compute_shuffled_index(i, 9, seed, spec.shuffle_round_count)
                    for i in range(9)]})
    # ssz_static: a container, and a type out of the surface
    cp = T.Checkpoint(epoch=7, root=b"\x0c" * 32)
    _write(p0 / "ssz_static/Checkpoint/ssz_random/case_0",
           serialized__ssz_snappy=cp.as_ssz_bytes(),
           roots__yaml={"root": CS._hex(cp.tree_hash_root())})
    _write(p0 / "ssz_static/NotAContainer/ssz_random/case_0",
           serialized__ssz_snappy=b"\x00", roots__yaml={"root": CS._hex(bytes(32))})
    # fork_choice: anchor, two blocks, an invalid one, head checks
    fh = StateHarness(N, MIN, spec, sign=False)
    t = T.types_for(MIN)
    fh.state.latest_block_header = T.BeaconBlockHeader(
        body_root=t.BeaconBlockBody.default().tree_hash_root())
    anchor = clone_state(fh.state)
    anchor_block = t.BeaconBlock(slot=0, proposer_index=0, parent_root=bytes(32),
                                 state_root=anchor.tree_hash_root(),
                                 body=t.BeaconBlockBody.default())
    b1, fh.state = fh.produce_block(1)
    b2, fh.state = fh.produce_block(2)
    fbad, _ = fh.produce_block(3)
    fbad.message.proposer_index = (fbad.message.proposer_index + 1) % N
    gt, spd = anchor.genesis_time, spec.seconds_per_slot
    _write(p0 / "fork_choice/on_block/pyspec_tests/chain",
           anchor_state__ssz_snappy=anchor.as_ssz_bytes(),
           anchor_block__ssz_snappy=anchor_block.as_ssz_bytes(),
           block_0__ssz_snappy=b1.as_ssz_bytes(), block_1__ssz_snappy=b2.as_ssz_bytes(),
           block_bad__ssz_snappy=fbad.as_ssz_bytes(),
           steps__yaml=[{"tick": gt + 2 * spd}, {"block": "block_0"}, {"block": "block_1"},
                        {"checks": {"head": {"slot": 2, "root": CS._hex(
                            b2.message.tree_hash_root())}, "time": gt + 2 * spd,
                            "genesis_time": gt}},
                        {"block": "block_bad", "valid": False}])
    # fork and transition into altair
    alt = T.ChainSpec.minimal()
    alt.altair_fork_epoch = 0
    a1 = base / "minimal" / "altair"
    _write(a1 / "fork/fork/pyspec_tests/fork_basic", pre__ssz_snappy=g.as_ssz_bytes(),
           post__ssz_snappy=upgrade_to_altair(clone_state(g), MIN, alt).as_ssz_bytes())
    tr = T.ChainSpec.minimal()
    tr.altair_fork_epoch = 1
    th = StateHarness(N, MIN, tr, sign=False)
    pre = clone_state(th.state)
    tb = []
    for slot in (SLOTS - 1, SLOTS):
        signed, _ = th.produce_block(slot)
        th.apply_block(signed)
        tb.append(signed.as_ssz_bytes())
    _write(a1 / "transition/core/pyspec_tests/at_epoch_1", pre__ssz_snappy=pre.as_ssz_bytes(),
           meta__yaml={"fork_epoch": 1, "blocks_count": 2, "fork_block": 0},
           blocks_0__ssz_snappy=tb[0], blocks_1__ssz_snappy=tb[1],
           post__ssz_snappy=th.state.as_ssz_bytes())
    # merkle proofs of an altair state's current sync committee, and an
    # empty update ranking
    st = StateHarness(N, MIN, alt, sign=False).state
    roots = [ft.hash_tree_root(getattr(st, name)) for name, ft in st.ssz_fields]
    idx = [name for name, _ in st.ssz_fields].index("current_sync_committee")
    mt = TMP.MerkleTree(roots)
    proof = {"leaf": CS._hex(roots[idx]), "leaf_index": mt.generalized_index_of_chunk(idx),
             "branch": [CS._hex(b) for b in mt.proof(idx)]}
    for d in ("light_client/single_merkle_proof/BeaconState/sync_committee",
              "merkle_proof/single_merkle_proof/BeaconState/sync_committee",
              "merkle/single_proof/BeaconState/sync_committee"):
        _write(a1 / d, object__ssz_snappy=st.as_ssz_bytes(), proof__yaml=proof)
    _write(a1 / "light_client/update_ranking/pyspec_tests/none",
           meta__yaml={"updates_count": 0})
    # ssz_generic
    gen = base / "general" / "phase0" / "ssz_generic"
    _write(gen / "uints/valid/uint_8_one", serialized__ssz_snappy=b"\x01",
           meta__yaml={"root": CS._hex(b"\x01" + bytes(31))}, value__yaml=1)
    _write(gen / "uints/invalid/uint_8_two_bytes", serialized__ssz_snappy=b"\x01\x02")
    _write(gen / "boolean/valid/true", serialized__ssz_snappy=b"\x01",
           meta__yaml={"root": CS._hex(b"\x01" + bytes(31))}, value__yaml=True)
    _write(gen / "containers/valid/SingleFieldTestStruct_0",
           serialized__ssz_snappy=b"\x05", meta__yaml={"root": CS._hex(b"\x05" + bytes(31))})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    saved = (tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    tapi.set_backend("fake")
    try:
        root = tmp_path_factory.mktemp("ef")
        host = CS.HostCrypto()
        spec = T.ChainSpec.minimal()
        datas = CS.genesis_deposit_data(C, spec, CS.GENESIS_DEPOSITS, host, sign=False)
        deposits = CS.deposit_list(C, datas)[1]
        state = C.genesis.initialize_beacon_state_from_eth1(
            CS.ETH1_BLOCK_HASH, spec.min_genesis_time, deposits, MIN, spec)
        cases = CS.write_ef_tree(C, str(root), host, genesis=(
            CS.ETH1_BLOCK_HASH, spec.min_genesis_time, deposits, state, spec))
        _state_cases(root / "tests", host)
    finally:
        tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE = saved
    return root, cases


def _listing(results):
    return [(r.path, r.ok, r.message) for r in results]


def test_the_walker_over_every_runner_equals_jax_on_fake(tree, monkeypatch):
    root, cases = tree
    jax_keys_decompressed(monkeypatch)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    got, want = TE.run_tree(str(root)), JE.run_tree(str(root))
    assert _listing(got) == _listing(want)
    runners = {Path(r.path).relative_to(root).parts[3] for r in got}
    assert runners == set(TE._RUNNERS) == set(JE._RUNNERS)
    # the fake backend accepts every decodable claim: the BLS cases that
    # expect False of a valid encoding are the only failures
    failed = {r.path for r in got if not r.ok}
    assert failed == {d for d, data in cases.items() if data is not None
                      and not data["output"] and "got True" in
                      next(r.message for r in got if r.path == d)}
    assert all("crash" not in r.message for r in got)
    assert len(got) == len(cases) + 22


@pytest.mark.parametrize("kinds", [(("aggregate_verify", "valid"),
                                    ("batch_verify", "invalid_set"))])
def test_bls_cases_on_the_cpu_oracles_equal_jax(tree, tmp_path, kinds):
    root, cases = tree
    for handler, kind in kinds:
        name = f"{handler}_{kind}"
        src = root / "tests/general/phase0/bls" / handler / "bls" / name
        shutil.copytree(src, tmp_path / "tests/general/phase0/bls" / handler / "bls" / name)
        assert json.loads((src / "data.yaml").read_text()) == cases[str(src)]
    japi.set_backend("cpu")
    tapi.set_backend("cpu")
    got, want = TE.run_tree(str(tmp_path)), JE.run_tree(str(tmp_path))
    assert _listing(got) == _listing(want)
    assert len(got) == len(kinds) and all(r.ok for r in got)


def test_the_walker_reads_json_yaml_as_the_yaml_reader_does(tree):
    """The phase writes its YAML files as JSON; PyYAML reads them as the
    same values."""
    import yaml

    root, _ = tree
    files = list(Path(root).rglob("*.yaml"))
    assert files
    for f in files:
        assert yaml.safe_load(f.read_text()) == json.loads(f.read_text()), f
