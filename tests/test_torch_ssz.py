"""The port's SSZ (lighthouse_tpu_torch/ssz, types/containers.py) against
the JAX package's: every container of `types_for(MINIMAL)` and
`types_for(MAINNET)` and every module-level container, at its default and
at seeded values, encodes to the same bytes, decodes the JAX side's bytes
to an object that re-encodes to them, and has the same hash_tree_root;
`cached_root` equals the plain root after seeded field updates, and the
chunk-tree cache equals `merkleize` as lists grow and shrink. Pure host
code on both sides: no XLA compile, no tensor."""

import random

import pytest

from lighthouse_tpu.ssz import hash as JH
from lighthouse_tpu.ssz import types as JS
from lighthouse_tpu.types import MAINNET as J_MAINNET
from lighthouse_tpu.types import MINIMAL as J_MINIMAL
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu_torch.ssz import ChunkTreeCache, cached_root
from lighthouse_tpu_torch.ssz import hash as TH
from lighthouse_tpu_torch.ssz import types as TS
from lighthouse_tpu_torch.types import containers as TC
from torch_port_util import carry, port_preset

PRESETS = {"minimal": J_MINIMAL, "mainnet": J_MAINNET}


def _module_containers(mod, container_type):
    return sorted(
        name for name, obj in vars(mod).items()
        if isinstance(obj, type)
        and isinstance(getattr(obj, "ssz_type", None), container_type))


def _preset_containers(preset):
    return sorted(k for k, v in vars(JC.types_for(preset)).items() if isinstance(v, type))


CASES = [(None, n) for n in _module_containers(JC, JS.Container)] + [
    (p, n) for p in sorted(PRESETS) for n in _preset_containers(PRESETS[p])]


def _classes(preset_name, name):
    if preset_name is None:
        return getattr(JC, name), getattr(TC, name)
    jp = PRESETS[preset_name]
    return (getattr(JC.types_for(jp), name),
            getattr(TC.types_for(port_preset(jp)), name))


def rand_value(t, rng):
    """A seeded value of the JAX descriptor `t`: lists, bitlists and byte
    lists of a few elements (their limits reach 2^40), vectors at full
    length."""
    if isinstance(t, JS._UInt):
        return rng.getrandbits(8 * t.byte_len)
    if isinstance(t, JS._Boolean):
        return rng.random() < 0.5
    if isinstance(t, JS.ByteVector):
        return rng.randbytes(t.length)
    if isinstance(t, JS.ByteList):
        return rng.randbytes(rng.randint(0, min(t.limit, 40)))
    if isinstance(t, JS.Bitvector):
        return tuple(rng.random() < 0.5 for _ in range(t.length))
    if isinstance(t, JS.Bitlist):
        return tuple(rng.random() < 0.5 for _ in range(rng.randint(0, min(t.limit, 12))))
    if isinstance(t, JS.Vector):
        return tuple(rand_value(t.elem, rng) for _ in range(t.length))
    if isinstance(t, JS.List):
        return tuple(rand_value(t.elem, rng) for _ in range(rng.randint(0, min(t.limit, 3))))
    if isinstance(t, JS.Container):
        return t.cls(**{name: rand_value(ft, rng) for name, ft in t.fields})
    raise TypeError(t)


def test_same_containers_in_both_packages():
    assert (_module_containers(TC, TS.Container)
            == _module_containers(JC, JS.Container))
    for p, jp in PRESETS.items():
        want = _preset_containers(jp)
        assert sorted(k for k, v in vars(TC.types_for(port_preset(jp))).items()
                      if isinstance(v, type)) == want
        assert len(want) >= 30


@pytest.mark.parametrize("preset_name, name", CASES)
def test_container_bytes_and_roots_equal_jax(preset_name, name):
    jcls, tcls = _classes(preset_name, name)
    assert [n for n, _ in tcls.ssz_fields] == [n for n, _ in jcls.ssz_fields]
    # defaults
    jd, td = jcls.default(), tcls.default()
    assert td.as_ssz_bytes() == jd.as_ssz_bytes()
    assert td.tree_hash_root() == jd.tree_hash_root()
    assert tcls.ssz_type.is_fixed() == jcls.ssz_type.is_fixed()
    # seeded values: the JAX object's bytes, decoded by the port
    rng = random.Random(f"{preset_name}/{name}")
    jv = rand_value(jcls.ssz_type, rng)
    data = jv.as_ssz_bytes()
    tv = carry(jv, tcls)
    assert tv.as_ssz_bytes() == data
    assert tv.tree_hash_root() == jv.tree_hash_root()
    assert tv == tcls.from_ssz_bytes(data)


@pytest.mark.parametrize("fork", ["phase0", "altair", "bellatrix"])
def test_cached_root_follows_seeded_field_updates(fork):
    """cached_root after each of a run of seeded updates (slot, a
    re-tupled validator, balances, a randao mix, participation) equals the
    plain root and the JAX root of the same state."""
    jt = JC.types_for(J_MINIMAL)
    tt = TC.types_for(port_preset(J_MINIMAL))
    jcls, tcls = JC.state_class_for(jt, fork), TC.state_class_for(tt, fork)
    rng = random.Random(fork)
    jv = rand_value(jcls.ssz_type, rng)
    jv.validators = tuple(rand_value(JC.Validator.ssz_type, rng) for _ in range(9))
    jv.balances = tuple(rng.getrandbits(64) for _ in range(9))
    state = carry(jv, tcls)
    assert cached_root(state) == state.tree_hash_root() == jv.tree_hash_root()
    for step in range(6):
        state.slot = rng.getrandbits(64)
        vals = list(state.validators)
        i = rng.randrange(len(vals))
        vals[i] = TC.Validator.from_ssz_bytes(
            rand_value(JC.Validator.ssz_type, rng).as_ssz_bytes())
        if step % 2:
            vals.append(vals[0])
        state.validators = tuple(vals)
        state.balances = tuple(rng.getrandbits(64) for _ in vals)
        mixes = list(state.randao_mixes)
        mixes[rng.randrange(len(mixes))] = rng.randbytes(32)
        state.randao_mixes = tuple(mixes)
        if fork != "phase0":
            state.current_epoch_participation = tuple(
                rng.getrandbits(3) for _ in vals)
        root = cached_root(state)
        assert root == state.tree_hash_root()
        assert root == jcls.from_ssz_bytes(state.as_ssz_bytes()).tree_hash_root()


@pytest.mark.parametrize("limit", [None, 5, 64])
def test_chunk_tree_cache_equals_merkleize(limit):
    """Seeded edits: a changed chunk, and (for a list's limit; a vector's
    width is fixed by its first update) a chunk appended or dropped."""
    rng = random.Random(limit)
    cache = ChunkTreeCache(limit)
    chunks = [rng.randbytes(32) for _ in range(5)]
    for _ in range(12):
        assert cache.update(list(chunks)) == JH.merkleize(chunks, limit)
        assert TH.merkleize(chunks, limit) == JH.merkleize(chunks, limit)
        op = rng.random()
        if op < 0.4 or limit is None:
            chunks[rng.randrange(len(chunks))] = rng.randbytes(32)
        elif op < 0.7 and len(chunks) < limit:
            chunks.append(rng.randbytes(32))
        elif len(chunks) > 1:
            chunks.pop()


def test_hash_helpers_equal_jax():
    rng = random.Random(7)
    assert TH.ZERO_HASHES == JH.ZERO_HASHES
    for n in (0, 1, 31, 32, 33, 100):
        data = rng.randbytes(n)
        assert TH.pack_bytes(data) == JH.pack_bytes(data)
        root = rng.randbytes(32)
        assert TH.mix_in_length(root, n) == JH.mix_in_length(root, n)
        assert TH.hash_concat(data, root) == JH.hash_concat(data, root)
