"""The port's execution side (lighthouse_tpu_torch/utils/jsonrpc.py and
execution_layer/) against the JAX package's on the CPU, byte for byte:

- keccak-256 and the sponge's SHA3-256 on seeded inputs of every padding
  length class (SHA3 also against hashlib), RLP, `ordered_trie_root`,
  and a seeded payload's block hash and transactions root; a tampered
  hash refused by both;
- JWT tokens at a fixed `now`, each package's token accepted by the
  other; a stale and a wrong-key token refused by both;
- the engine API's payload JSON both ways;
- the mock engines' payloads (equal SSZ bytes and roots) and statuses,
  in process and through an EngineRpcServer behind JWT (one server per
  test, stopped in `finally`, its clients on a short timeout);
- `BeaconChainHarness(16, MINIMAL, sign=False)` on both packages' `fake`
  backend across phase0 -> altair -> bellatrix with a mock engine: equal
  blocks, head and head state roots after every block, and equal engine
  logs; then the invalidation reorg to the same heads.

A `gpu`-marked test imports signed payload-bearing blocks on the card.
The JAX side takes its public keys from the port's bytes
(`jax_keys_from_port`). No XLA compile."""

import hashlib

import numpy as np
import pytest

from lighthouse_tpu import execution_layer as JX
from lighthouse_tpu import types as J
from lighthouse_tpu.chain import pubkey_cache as JPC
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.execution_layer import block_hash as JBH
from lighthouse_tpu.execution_layer import http_engine as JHE
from lighthouse_tpu.execution_layer import keccak as JK
from lighthouse_tpu.execution_layer import rlp as JR
from lighthouse_tpu.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.types import sync_committee as JSC
from lighthouse_tpu_torch import execution_layer as X
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.execution_layer import block_hash as BH
from lighthouse_tpu_torch.execution_layer import http_engine as HE
from lighthouse_tpu_torch.execution_layer import keccak as KK
from lighthouse_tpu_torch.execution_layer import rlp as R
from lighthouse_tpu_torch.harness import BeaconChainHarness
from lighthouse_tpu_torch.ssz import cached_root
from torch_port_util import carry, jax_keys_from_port, need_card, no_xla_compile

SPE = T.MINIMAL.slots_per_epoch
LENGTHS = (0, 1, 31, 32, 33, 64, 135, 136, 137, 271, 272, 1000)
NOW = 1_700_000_000.0
SECRET = bytes(range(32))


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_keccak_and_sha3_equal_jax_and_hashlib(n):
    data = _bytes(np.random.default_rng(n), n)
    assert KK.keccak256(data) == JK.keccak256(data)
    assert KK.sha3_256(data) == JK.sha3_256(data) == hashlib.sha3_256(data).digest()


def test_rlp_and_trie_roots_equal_jax():
    rng = np.random.default_rng(7)
    for n in (0, 1, 55, 56, 57, 300):
        data = _bytes(rng, n)
        assert R.encode_bytes(data) == JR.encode_bytes(data)
    for v in (0, 1, 15, 127, 128, 1024, 2**64 - 1, int(rng.integers(0, 2**62))):
        assert R.encode_int(v) == JR.encode_int(v)
    items = [R.encode_bytes(_bytes(rng, int(k))) for k in rng.integers(0, 80, 9)]
    assert R.encode_list(items) == JR.encode_list(items)
    assert R.EMPTY_TRIE_ROOT == JR.EMPTY_TRIE_ROOT
    for n in (0, 1, 2, 16, 17, 200):
        vals = [_bytes(rng, int(k)) for k in rng.integers(1, 90, n)]
        assert R.ordered_trie_root(vals) == JR.ordered_trie_root(vals)


def _payloads(seed):
    """The same seeded payload in both packages (six transactions)."""
    rng = np.random.default_rng(seed)
    fields = dict(
        parent_hash=_bytes(rng, 32), fee_recipient=_bytes(rng, 20),
        state_root=_bytes(rng, 32), receipts_root=_bytes(rng, 32),
        logs_bloom=_bytes(rng, 256), prev_randao=_bytes(rng, 32),
        block_number=int(rng.integers(1, 2**40)), gas_limit=30_000_000,
        gas_used=int(rng.integers(0, 30_000_000)), timestamp=int(rng.integers(0, 2**40)),
        extra_data=_bytes(rng, 17), base_fee_per_gas=int(rng.integers(1, 2**60)),
        transactions=[_bytes(rng, int(k)) for k in rng.integers(1, 200, 6)])
    tp = T.types_for(T.MINIMAL).ExecutionPayload(**fields)
    jp = J.types_for(J.MINIMAL).ExecutionPayload(**fields)
    tp.block_hash = BH.calculate_execution_block_hash(tp)
    jp.block_hash = JBH.calculate_execution_block_hash(jp)
    return tp, jp


@pytest.mark.parametrize("seed", (1, 2))
def test_payload_block_hash_equal_jax_and_tamper_refused_alike(seed):
    tp, jp = _payloads(seed)
    assert tp.as_ssz_bytes() == jp.as_ssz_bytes()
    assert bytes(tp.block_hash) == bytes(jp.block_hash)
    assert BH.calculate_transactions_root(tp.transactions) == \
        JBH.calculate_transactions_root(jp.transactions)
    BH.verify_payload_block_hash(tp)
    JBH.verify_payload_block_hash(jp)
    tp.block_hash = jp.block_hash = b"\x99" * 32
    errors = []
    for verify, p in ((BH.verify_payload_block_hash, tp),
                      (JBH.verify_payload_block_hash, jp)):
        with pytest.raises(ValueError) as e:
            verify(p)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_jwt_tokens_equal_and_refused_alike():
    tkey, jkey = X.JwtKey(SECRET), JX.JwtKey(SECRET)
    assert tkey.to_hex() == jkey.to_hex()
    token = X.generate_token(tkey, now=NOW)
    assert token == JX.generate_token(jkey, now=NOW)
    assert X.validate_token(tkey, token, now=NOW + 30) == JX.validate_token(
        jkey, token, now=NOW + 30)
    wrong_t, wrong_j = X.JwtKey(b"\x01" * 32), JX.JwtKey(b"\x01" * 32)
    for validate, err, key, wrong in ((X.validate_token, X.JwtError, tkey, wrong_t),
                                      (JX.validate_token, JX.JwtError, jkey, wrong_j)):
        with pytest.raises(err, match="stale|iat"):
            validate(key, token, now=NOW + 1000)
        with pytest.raises(err, match="bad signature"):
            validate(wrong, token, now=NOW)


def test_payload_json_equal_both_ways():
    tp, jp = _payloads(3)
    obj = HE.payload_to_json(tp)
    assert obj == JHE.payload_to_json(jp)
    tcls, jcls = type(tp), type(jp)
    assert HE.payload_from_json(JHE.payload_to_json(jp), tcls).as_ssz_bytes() == \
        tp.as_ssz_bytes()
    assert JHE.payload_from_json(obj, jcls).as_ssz_bytes() == jp.as_ssz_bytes()


def _engines():
    return (X.MockExecutionEngine(T.types_for(T.MINIMAL)),
            JX.MockExecutionEngine(J.types_for(J.MINIMAL)))


def test_mock_engine_payloads_and_statuses_equal_jax():
    te, je = _engines()
    assert te.genesis_hash == je.genesis_hash
    tel, jel = X.ExecutionLayer(te), JX.ExecutionLayer(je)
    statuses = []
    for i, (ts, randao) in enumerate(((1234, b"\x07" * 32), (1240, b"\x08" * 32))):
        parent = te.genesis_hash if i == 0 else bytes(tp.block_hash)
        tp = tel.get_payload(parent, ts, randao, fee_recipient=b"\xaa" * 20)
        jp = jel.get_payload(parent, ts, randao, fee_recipient=b"\xaa" * 20)
        assert tp.as_ssz_bytes() == jp.as_ssz_bytes()
        assert tp.tree_hash_root() == jp.tree_hash_root()
        statuses.append((tel.notify_new_payload(tp).value,
                         jel.notify_new_payload(jp).value))
    te.force_syncing = je.force_syncing = 1
    tp = tel.get_payload(bytes(tp.block_hash), 1250, b"\x09" * 32)
    jp = jel.get_payload(bytes(jp.block_hash), 1250, b"\x09" * 32)
    statuses.append((tel.notify_new_payload(tp).value, jel.notify_new_payload(jp).value))
    te.mark_invalid(bytes(tp.block_hash))
    je.mark_invalid(bytes(jp.block_hash))
    errors = []
    for el, p, err in ((tel, tp, X.PayloadInvalid), (jel, jp, JX.PayloadInvalid)):
        with pytest.raises(err) as e:
            el.notify_new_payload(p)
        errors.append((str(e.value), e.value.latest_valid_hash))
    assert errors[0] == errors[1]
    assert statuses == [("verified",) * 2] * 2 + [("optimistic",) * 2]
    assert te.new_payload_log == je.new_payload_log


def test_engine_over_http_and_jwt_equals_the_in_process_engine():
    te, je = _engines()
    key = X.JwtKey(SECRET)
    server = X.EngineRpcServer(te, key).start()
    try:
        engine = X.HttpJsonRpcEngine(server.url, key, te.payload_cls, retries=2,
                                     backoff_s=0.01, timeout_s=2.0)
        tel = X.ExecutionLayer(engine, pre_merge_parent_hash=te.genesis_hash)
        jel = JX.ExecutionLayer(je)
        tp = tel.get_payload(te.genesis_hash, 77, b"\x05" * 32)
        jp = jel.get_payload(je.genesis_hash, 77, b"\x05" * 32)
        assert tp.as_ssz_bytes() == jp.as_ssz_bytes()
        assert tel.notify_new_payload(tp) is X.PayloadVerificationStatus.VERIFIED
        assert jel.notify_new_payload(jp) is JX.PayloadVerificationStatus.VERIFIED
        assert te.new_payload_log == je.new_payload_log
        # a tampered hash is refused before the wire
        seen = server.requests_seen
        bad = type(tp).from_ssz_bytes(tp.as_ssz_bytes())
        bad.block_hash = b"\x99" * 32
        with pytest.raises(X.PayloadInvalid):
            tel.notify_new_payload(bad)
        assert server.requests_seen == seen
        # a transient 503 is retried; a bad token fails fast (HTTP 401)
        server.fail_next = 1
        assert engine.get_payload(b"\x00" * 7 + b"\x01").as_ssz_bytes() == \
            tp.as_ssz_bytes()
        server.reject_auth = True
        with pytest.raises(X.EngineApiError, match="401"):
            engine.new_payload(tp)
        assert server.requests_seen == seen + 3
    finally:
        server.stop()


# --- the fork crossing and the invalidation reorg on both packages -----------


def _spec(pkg):
    return pkg.ChainSpec.interop(altair_fork_epoch=1, bellatrix_fork_epoch=2)


@pytest.fixture(scope="module")
def crossed():
    """Both packages' harness (16 validators, sign=False, `fake` backend)
    with a mock engine, extended a block at a time for 3 epochs; the
    views after every block."""
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        mp.setattr(JPC, "_validated", JSC.PublicKey.from_bytes)
        japi.set_backend("fake")
        tapi.set_backend("fake")
        te, je = _engines()
        th = BeaconChainHarness(16, T.MINIMAL, _spec(T), execution_layer=X.ExecutionLayer(te),
                                device="cpu")
        jh = JHarness(16, J.MINIMAL, _spec(J), execution_layer=JX.ExecutionLayer(je))
        views = []
        for _ in range(3 * SPE):
            th.extend_chain(1)
            jh.extend_chain(1)
            views.append(((th.chain.head_root, cached_root(th.chain.head_state),
                           th.chain.head_state.fork_name),
                          (jh.chain.head_root, jh.chain.head_state.tree_hash_root(),
                           jh.chain.head_state.fork_name)))
        yield th, jh, te, je, views
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def test_fork_crossing_equals_jax_block_by_block(crossed):
    th, jh, te, je, views = crossed
    assert [t for t, _ in views] == [j for _, j in views]
    assert [v[0][2] for v in views[SPE - 2:SPE + 1]] == ["phase0", "altair", "altair"]
    assert views[-1][0][2] == "bellatrix"
    assert te.new_payload_log == je.new_payload_log
    assert len(te.new_payload_log) == SPE + 1  # slots 16-24
    head_hash = bytes(th.chain.head_state.latest_execution_payload_header.block_hash)
    assert head_hash in te.blocks and head_hash in je.blocks


def test_invalidation_reorg_equals_jax(crossed):
    """tests/test_execution_layer.py's reorg on both packages: A and its
    child A2 imported while the engine reports SYNCING, B beside A; A's
    payload marked invalid; both heads move to the same B."""
    th, jh, te, je, _ = crossed
    heads = []
    for h, engine in ((th, te), (jh, je)):
        base_root, base_slot = h.chain.head_root, h.chain.head_state.slot
        engine.force_syncing = 2
        roots = []
        for off, parent in ((1, base_root), (2, None), (3, base_root)):
            block, _ = h.producer.produce_block(
                base_slot + off, base_state=h.chain._states[parent or roots[-1]])
            h.chain.slot_clock.set_slot(base_slot + off)
            roots.append(h.chain.process_block(block, strategy=h.strategy))
            if off == 1:
                hash_a = bytes(block.message.body.execution_payload.block_hash)
        assert h.chain.is_optimistic(roots[0]) and h.chain.is_optimistic(roots[1])
        engine.mark_invalid(hash_a)
        new_head = h.chain.on_invalid_payload(roots[0])
        status = h.chain.fork_choice.proto.execution_status_of
        assert new_head == roots[2] == h.chain.head_root
        assert [status(r) for r in roots[:2]] == ["invalid"] * 2
        heads.append((roots, new_head))
    assert heads[0] == heads[1]
    assert te.new_payload_log == je.new_payload_log


@pytest.mark.gpu
def test_signed_payload_blocks_import_on_the_card():
    """A signed harness chain crossing into bellatrix with every block
    verified on the card (VERIFY_BULK on torch_cuda), the engine reached
    over HTTP with JWT: every payload VERIFIED, the head's known to it."""
    need_card()
    saved = (tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    tapi.set_backend("torch_cuda")
    te = X.MockExecutionEngine(T.types_for(T.MINIMAL))
    key = X.JwtKey(SECRET)
    server = X.EngineRpcServer(te, key).start()
    try:
        el = X.ExecutionLayer(
            X.HttpJsonRpcEngine(server.url, key, te.payload_cls, timeout_s=5.0),
            pre_merge_parent_hash=te.genesis_hash)
        spec = T.ChainSpec.interop(altair_fork_epoch=0, bellatrix_fork_epoch=1)
        h = BeaconChainHarness(16, T.MINIMAL, spec, sign=True, execution_layer=el)
        assert h.chain.pubkey_cache.device_table().device.type == "cuda"
        h.extend_chain(SPE + 2)
        assert h.chain.head_state.fork_name == "bellatrix"
        assert len(te.new_payload_log) == 3
        head = bytes(h.chain.head_state.latest_execution_payload_header.block_hash)
        assert head in te.blocks
    finally:
        server.stop()
        tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE = saved


def test_payload_carries_across_packages():
    """A port payload decodes in the JAX package to the same root."""
    tp, jp = _payloads(4)
    assert carry(tp, type(jp)).tree_hash_root() == tp.tree_hash_root()
