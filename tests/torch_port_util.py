"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; a JAX
function runs jitted on the CPU, its port counterpart on CPU torch tensors
(where every kernel wrapper takes its plain version), and the int32
results must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W = 35

# The port's CPU tensors are tiny: one intra-op thread is fastest, and
# several pytest workers each spinning a full thread pool starve each
# other (and every other test on the machine).
torch.set_num_threads(1)


def lazy(rng, shape, maximal_rows=0):
    """Random limbs over the whole lazy range [-1, 2^12]; the first
    `maximal_rows` rows (leading axis) have every limb at 2^12."""
    a = rng.integers(-1, (1 << 12) + 1, size=tuple(shape) + (W,)).astype(np.int32)
    if maximal_rows:
        a[:maximal_rows] = 1 << 12
    return a


def run_jax(fn, *args):
    out = jax.jit(fn)(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def run_torch(fn, *args):
    out = fn(*[torch.as_tensor(np.array(a)) for a in args])
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


def assert_same(jax_fn, torch_fn, *args):
    """JAX (jitted) and port outputs identical, array for array."""
    want = run_jax(jax_fn, *args)
    got = run_torch(torch_fn, *args)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape, (w.shape, g.shape)
        assert w.dtype == g.dtype or (w.dtype == np.bool_ and g.dtype == np.bool_)
        np.testing.assert_array_equal(g, w)


def make_signed(n_keys=6, n_msgs=3):
    """Keys and messages with lazily made JAX-side signatures: (secret
    keys, messages, sig(key i, message m))."""
    from lighthouse_tpu.crypto.bls import api as japi

    sks = [japi.SecretKey(424242 + 1009 * i) for i in range(n_keys)]
    msgs = [b"slot-%d-attestation" % i for i in range(n_msgs)]
    sigs = {}

    def sig(i, m):
        if (i, m) not in sigs:
            sigs[i, m] = sks[i].sign(msgs[m])
        return sigs[i, m]

    return sks, msgs, sig


def both(signed, spec):
    """spec: [(key indices, message index, signer override or None)] ->
    (jax sets, port sets). A set's signature aggregates its keys'
    signatures over `signer`'s message (a forgery when it differs); the
    port's keys and signatures are decoded from the JAX side's bytes."""
    from lighthouse_tpu.crypto.bls import api as japi
    from lighthouse_tpu_torch.crypto.bls import api as tapi

    sks, msgs, sig = signed
    jsets, tsets = [], []
    for keys, m, signed_m in spec:
        s = japi.AggregateSignature.aggregate(
            [sig(i, m if signed_m is None else signed_m) for i in keys]
        ).to_signature()
        jpks = [sks[i].public_key() for i in keys]
        jsets.append(japi.SignatureSet.multiple_pubkeys(s, jpks, msgs[m]))
        tsets.append(tapi.SignatureSet.multiple_pubkeys(
            tapi.Signature.from_bytes(s.to_bytes()),
            [tapi.PublicKey.from_bytes(pk.to_bytes()) for pk in jpks],
            msgs[m],
        ))
    return jsets, tsets


def no_xla_compile():
    """Context manager: fail if JAX compiled any XLA program inside it
    (the seam's parity tests hand both packages host work only)."""
    import contextlib

    import jax.monitoring as monitoring
    from jax._src.dispatch import BACKEND_COMPILE_EVENT

    @contextlib.contextmanager
    def guard():
        seen = []

        def listener(event, duration, **kw):
            if event == BACKEND_COMPILE_EVENT:
                seen.append(duration)

        monitoring.register_event_duration_secs_listener(listener)
        try:
            yield
        finally:
            monitoring.unregister_event_duration_listener(listener)
        assert not seen, f"{len(seen)} XLA compiles"

    return guard()


def need_card():
    """Skip (with the reason) unless a CUDA device and nvcc are present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


# --- consensus objects across the packages ------------------------------------


def port_preset(jax_preset):
    """The port's preset of the same name as a JAX one."""
    from lighthouse_tpu_torch.types import presets

    return getattr(presets, jax_preset.name.upper())


def carry_state(jax_state, jax_preset):
    """A JAX BeaconState as the port's: the JAX side encodes it, the port
    decodes the SSZ bytes (any fork)."""
    from lighthouse_tpu_torch.types import decode_state_any_fork

    return decode_state_any_fork(jax_state.as_ssz_bytes(), port_preset(jax_preset))


def carry_block(jax_signed_block, jax_preset):
    """A JAX SignedBeaconBlock as the port's, through its SSZ bytes."""
    from lighthouse_tpu_torch.types import decode_block_any_fork

    return decode_block_any_fork(
        jax_signed_block.as_ssz_bytes(), port_preset(jax_preset))


def carry(jax_obj, port_cls):
    """Any JAX SSZ container as an instance of `port_cls`, through its
    SSZ bytes."""
    return port_cls.from_ssz_bytes(jax_obj.as_ssz_bytes())


def jax_keys_from_port(monkeypatch):
    """Let the JAX package's interop genesis (and its sync committees and
    signature-set builders) take the public keys from the port's bytes,
    decompressed without the subgroup check (the JAX host
    oracle spends ~0.18 s a key on the scalar multiplication and as much
    on the check; the port ~1 ms and ~19 ms). Secret keys stay the JAX
    package's own, so its signatures are its own. The keys themselves
    are held across the packages by test_torch_types.py's keypair tests
    (every secret key, the first public keys)."""
    import functools

    from lighthouse_tpu.crypto.bls import api as japi
    from lighthouse_tpu.crypto.bls import curve_ref as JC
    from lighthouse_tpu.state_transition import signature_sets as JSS
    from lighthouse_tpu.types import interop as JI
    from lighthouse_tpu.types import sync_committee as JS
    from lighthouse_tpu_torch.types import interop as TI

    @functools.lru_cache(maxsize=None)
    def keypair(index):
        pk = TI.interop_keypair(index)[1].to_bytes()
        return JI.interop_secret_key(index), japi.PublicKey(
            JC.g1_from_bytes(pk), pk, subgroup_checked=True)

    class _Decompressed:
        @staticmethod
        def from_bytes(data):
            return japi.PublicKey(
                JC.g1_from_bytes(bytes(data)), bytes(data), subgroup_checked=True)

    monkeypatch.setattr(JI, "interop_keypair", keypair)
    monkeypatch.setattr(JS, "PublicKey", _Decompressed)
    # the signature-set builders' registry getter decompresses the same keys
    monkeypatch.setattr(JSS, "_decompress", _Decompressed.from_bytes)
    return keypair


def jax_keys_decompressed(monkeypatch):
    """Let the JAX package decompress public keys from bytes without the
    subgroup check (~0.18 s a key), through `api.PublicKey.from_bytes`
    and the signature-set builders that call it (deposits); the infinity
    key is still refused. For keys the port made, which are valid."""
    from lighthouse_tpu.crypto.bls import api as japi
    from lighthouse_tpu.crypto.bls import curve_ref as JC
    from lighthouse_tpu.state_transition import signature_sets as JSS

    def from_bytes(cls, data):
        point = JC.g1_from_bytes(bytes(data))
        if point.inf:
            raise japi.BlsError("public key is the point at infinity")
        return cls(point, bytes(data), subgroup_checked=True)

    monkeypatch.setattr(japi.PublicKey, "from_bytes", classmethod(from_bytes))
    monkeypatch.setattr(JSS, "PublicKey", japi.PublicKey)


def scenario_sandbox(monkeypatch):
    """Run scenarios in this test and leave the process as it found it:
    both packages' backend (name and, in the port, device), tracer,
    ledger, verify pipeline and scheduler are put back at teardown, and
    the four histograms the health block reads start fresh in both
    packages (earlier tests in the worker feed them differently)."""
    from lighthouse_tpu.crypto.bls import api as japi
    from lighthouse_tpu.crypto.bls import pipeline as JP
    from lighthouse_tpu.crypto.bls import scheduler as JSCH
    from lighthouse_tpu.obs import ledger as JL
    from lighthouse_tpu.utils import metrics as JM
    from lighthouse_tpu.utils import tracing as JT
    from lighthouse_tpu_torch.crypto.bls import api as tapi
    from lighthouse_tpu_torch.crypto.bls import pipeline as TP
    from lighthouse_tpu_torch.crypto.bls import scheduler as TSCH
    from lighthouse_tpu_torch.obs import ledger as TL
    from lighthouse_tpu_torch.utils import metrics as TM
    from lighthouse_tpu_torch.utils import monitoring as TMON
    from lighthouse_tpu_torch.utils import tracing as TT

    for mod in (JP, JSCH, JL, JT, TP, TSCH, TL, TT):
        monkeypatch.setattr(mod, "_DEFAULT", mod._DEFAULT)
    for name in ("_BACKEND", "_BACKEND_NAME"):
        monkeypatch.setattr(japi, name, getattr(japi, name))
        monkeypatch.setattr(tapi, name, getattr(tapi, name))
    monkeypatch.setattr(tapi, "_DEVICE", tapi._DEVICE)
    for M in (JM, TM):
        for _, name in TMON.HEALTH_HISTOGRAMS:
            old = getattr(M, name)
            monkeypatch.setattr(M, name, M.Histogram(old.name, old.help,
                                                     buckets=old.buckets))
