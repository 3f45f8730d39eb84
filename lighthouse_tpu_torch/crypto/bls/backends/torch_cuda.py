"""GPU batch-verification backend: the blst replacement on an NVIDIA card.

Port of lighthouse_tpu/crypto/bls/backends/jax_tpu.py's single-device
staged path. Same semantics as `verify_multiple_aggregate_signatures`
(reference crypto/bls/src/impls/blst.rs:36-119):

  host:   structural checks, distinct-message grouping, SHA-256 field
          draws, limb packing, random 64-bit weights (`_draw_weight_scalars`,
          the same numpy draws as the JAX backend for the same seed)
  device: the five stages below on int32 limb tensors, ending in ONE
          shared final exponentiation

Batch shapes are padded to power-of-two buckets exactly like the JAX
backend (padded sets get weight 0 and infinity points), so for one seed
both backends compute the same limbs at every stage.

Each stage is `@jax.jit` in the JAX backend: one compiled executable per
shape. Here each runs on the card as one CUDA graph per shape
(`utils/cuda_graphs.py`): captured at its first call, replayed after.
`verify_body` is the whole per-set chain in one function, the JAX
backend's monolithic `verify_jit`; `_monolith_graphs` runs it as ONE
CUDA graph per shape when LIGHTHOUSE_TPU_MONOLITH=1.
`warm_compile` captures the stages of every bucket of
`DEFAULT_WARM_BUCKETS` before the first slot, and `_seen_shape_buckets`
is the in-process registry of the bucketed shapes run so far.

Also here: `aggregate_verify` (the spec's AggregateVerify through the same
stages plus `_stage_agg_prep`), and the device-resident validator
`PubkeyTable` with the index-gather marshalling route (`_common_table`,
`prepack_indices`, `_marshal_batch(index_pack=, pad_to=)`) and the
keyword duck type `dispatch_verify_signature_sets` that the pipeline and
the scheduler (crypto/bls/pipeline.py, scheduler.py) call.

Dispatch never reads a device value: the host arrays go to the card from
pinned memory with `non_blocking=True`, and the verdict is a zero-dim
device bool (the sync entry point reads it with `bool()`; the pipeline
through a pinned copy behind an event). Three switches,
read per call, match the JAX backend's: `LIGHTHOUSE_TPU_MSG_AGG=0` keeps
every batch on the per-set path, `LIGHTHOUSE_TPU_MONOLITH=1` sends every
batch (aggregated ones too) through `verify_body` as one graph, and
`LIGHTHOUSE_TPU_KEY_VALIDATE=0` skips the host key_validate (adversary
tests only). The marshal/dispatch seam
feeds the JAX backend's metric families (utils/metrics.py), opens its
`bls_marshal`/`bls_dispatch` spans (utils/tracing.py) and records
"dispatch" and "warm" rows on the launch ledger (obs/ledger.py).

Also here: the speculation correction, the device half of
speculate/precompute.py (`committee_table`, `set_committee_aggregates`,
`correct_aggregate_device` over `_stage_correct`, graphed per bucket of
the absent count).

Not yet in the port (see ROADMAP.md): the device mesh, so no sharded
table, no `verify_body_grouped` and no collectives in `verify_body`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ....obs import ledger as launch_ledger
from ....utils import metrics, tracing
from .. import aggregation as AG
from ..constants import G1_X as _G1_X, G1_Y as _G1_Y, P as _P
from ..curve_ref import Point
from ..fields_ref import Fp
from ..gpu import curve as TC
from ..gpu import hash_to_curve as THC
from ..gpu import limbs as L
from ..gpu import pairing as TP
from ..gpu import tower as T
from ....utils.cuda_graphs import graphed

W = L.W


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent CPU
    fallback. A CUDA device without an index gets the current one, so
    devices compare equal to those of the tensors placed on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch_cuda backend: no CUDA device (pass device='cpu' to run "
            "the plain versions on the CPU)"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`. To the card it goes from pinned
    memory with non_blocking=True: a copy from pageable memory would
    synchronize the stream, and so wait for every batch already queued.
    The pinned buffer goes back to PyTorch's host allocator, which keeps
    it until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


# --- packing helpers (cached on the api objects) ---------------------------


def _pk_limbs(pk) -> np.ndarray:
    """PublicKey -> (3, W) projective limbs (Z = 1), cached on the object."""
    cached = getattr(pk, "_tpu_limbs", None)
    if cached is None:
        pt = pk.point
        cached = np.stack(
            [L.to_limbs(pt.x.n), L.to_limbs(pt.y.n), L.to_limbs(1)]
        ).astype(np.int32)
        try:
            pk._tpu_limbs = cached
        except AttributeError:
            pass
    return cached


def _sig_limbs(sig) -> np.ndarray:
    """Signature -> (3, 2, W) projective limbs (infinity -> (0, 1, 0))."""
    cached = getattr(sig, "_tpu_limbs", None)
    if cached is None:
        pt = sig.point
        out = np.zeros((3, 2, W), np.int32)
        if pt.inf:
            out[1, 0] = L.to_limbs(1)
        else:
            out[0, 0] = L.to_limbs(pt.x.c0.n)
            out[0, 1] = L.to_limbs(pt.x.c1.n)
            out[1, 0] = L.to_limbs(pt.y.c0.n)
            out[1, 1] = L.to_limbs(pt.y.c1.n)
            out[2, 0] = L.to_limbs(1)
        cached = out
        try:
            sig._tpu_limbs = cached
        except AttributeError:
            pass
    return cached


_INF_G1 = np.zeros((3, W), np.int32)  # projective infinity (0, 1, 0)
_INF_G1[1, 0] = 1

_draws_cache: dict[bytes, np.ndarray] = {}


def _field_draws_cached(message: bytes) -> np.ndarray:
    """Field draws per message, cached with a simple size cap."""
    key = bytes(message)
    hit = _draws_cache.get(key)
    if hit is None:
        hit = THC.hash_to_field([key])[0]
        if len(_draws_cache) > 8192:
            _draws_cache.clear()
        _draws_cache[key] = hit
    return hit


# -G1 generator, affine
_NEG_G1_GEN_AFF = np.stack([L.to_limbs(_G1_X), L.to_limbs(_P - _G1_Y)])  # (2, W)


# --- the five stages ---------------------------------------------------------


def _stage_hash(u):
    """Message mapping H(m): field draws -> affine G2 points + inf mask."""
    return TC.to_affine_g2(THC.map_to_g2(u))


def _stage_prep(pk_jac, sig_jac, scalars, real):
    """Pubkey aggregation, subgroup checks, weight ladders, signature sum."""
    agg_pk = TC.sum_points(torch.movedim(pk_jac, 1, 0), TC.FP)
    agg_pk_bad = TC.is_infinity(agg_pk, TC.FP) & real
    sig_ok = TC.g2_subgroup_check(sig_jac)
    rpk = TC.scalar_mul_u64(agg_pk, scalars, TC.FP)
    rpk_aff, rpk_inf = TC.to_affine_g1(rpk)
    rsig = TC.scalar_mul_u64(sig_jac, scalars, TC.FP2)
    ssum = TC.sum_points(rsig, TC.FP2)
    ssum_aff, ssum_inf = TC.to_affine_g2(ssum[None])
    flags_ok = torch.all(sig_ok) & ~torch.any(agg_pk_bad)
    return rpk_aff, rpk_inf, ssum_aff, ssum_inf, flags_ok


def _stage_miller(rpk_aff, rpk_inf, h_aff, h_inf, ssum_aff, ssum_inf):
    """Pair assembly (incl. the -g1 generator pair), batched Miller loops
    (the two fused step kernels), halving product."""
    dev = rpk_aff.device
    p_aff = torch.cat([rpk_aff, L.on(_NEG_G1_GEN_AFF, dev)[None]], dim=0)
    p_inf = torch.cat([rpk_inf, torch.zeros((1,), dtype=torch.bool, device=dev)])
    q_aff = torch.cat([h_aff, ssum_aff], dim=0)
    q_inf = torch.cat([h_inf, ssum_inf], dim=0)
    f = TP.miller_loop(p_aff, p_inf, q_aff, q_inf)
    return TP.fp12_prod(f, axis=0)


def _stage_final(fprod, flags_ok):
    """ONE shared final exponentiation + the validity combine."""
    return T.fp12_is_one(TP.final_exponentiation(fprod)) & flags_ok


def _stage_group(rpk_aff, rpk_inf, grid_idx, grid_real):
    """Per-message pubkey aggregation over the (m_b, g_b) group grid
    (padding slots masked to infinity), then affine."""
    rows_aff = rpk_aff[grid_idx]  # (m_b, g_b, 2, W)
    rows_inf = rpk_inf[grid_idx] | ~grid_real
    rows = TC.from_affine(rows_aff, rows_inf, TC.FP)
    gpk = TC.sum_points(torch.movedim(rows, 1, 0), TC.FP)  # (m_b, 3, W)
    return TC.to_affine_g1(gpk)


def _stage_agg_prep(pk_jac, sig_jac, real):
    """Aggregate-verify prep: affine pubkeys (padding masked to infinity),
    the signature's subgroup check and affine form."""
    pk_aff, pk_inf = TC.to_affine_g1(pk_jac)
    sig_ok = TC.g2_subgroup_check(sig_jac[None])[0]
    sig_aff, sig_inf = TC.to_affine_g2(sig_jac[None])
    return pk_aff, pk_inf | ~real, sig_aff, sig_inf, sig_ok


STAGES = (_stage_hash, _stage_prep, _stage_miller, _stage_final)


def verify_body(u, pk_jac, sig_jac, scalars, real, axis_name=None):
    """The full per-set batch verify in one function, the single-device
    body of the JAX backend's `verify_body`: per-set draws `u` (n_b, 2, 2,
    W), no message axis. It runs the four per-set stages in one go, and
    reads no device value, so the whole chain captures as one graph
    (`_monolith_graphs`). The mesh form (`axis_name`, with the
    collectives) waits for the port's device mesh."""
    if axis_name is not None:
        raise NotImplementedError(
            "verify_body over a device mesh: the port has no mesh yet "
            "(ROADMAP.md Queue 1 item 12)")
    h_aff, h_inf = _stage_hash(u)
    rpk_aff, rpk_inf, ssum_aff, ssum_inf, flags_ok = _stage_prep(
        pk_jac, sig_jac, scalars, real)
    fprod = _stage_miller(rpk_aff, rpk_inf, h_aff, h_inf, ssum_aff, ssum_inf)
    return _stage_final(fprod, flags_ok)


# the stages as the entry points run them: on the card, one CUDA graph per
# shape (`graphed(...).fn` is the plain stage above)
_monolith_graphs = graphed(verify_body)
_hash_graphs = graphed(_stage_hash)
_prep_graphs = graphed(_stage_prep)
_miller_graphs = graphed(_stage_miller)
_final_graphs = graphed(_stage_final)
_group_graphs = graphed(_stage_group)
_agg_prep_graphs = graphed(_stage_agg_prep)


def verify_device(u, h_idx, pk_jac, sig_jac, scalars, real, timer=None):
    """The per-set staged verify: hash the distinct messages, expand to
    sets by `h_idx`, then prep, Miller, final. `timer(name, fn, *args)`
    wraps each stage when given (chip_smoke.py times them)."""
    run = timer or (lambda name, fn, *a: fn(*a))
    h_aff_u, h_inf_u = run("hash", _hash_graphs, u)
    h_aff, h_inf = h_aff_u[h_idx], h_inf_u[h_idx]
    rpk_aff, rpk_inf, ssum_aff, ssum_inf, flags_ok = run(
        "prep", _prep_graphs, pk_jac, sig_jac, scalars, real
    )
    fprod = run(
        "miller", _miller_graphs, rpk_aff, rpk_inf, h_aff, h_inf, ssum_aff, ssum_inf
    )
    return run("final", _final_graphs, fprod, flags_ok)


def verify_device_aggregated(
    u, pk_jac, sig_jac, scalars, real, grid_idx, grid_real, timer=None
):
    """The message-aggregated verify: the same prep, then the per-message
    group reduction, then ONE multi-pairing over m_b + 1 pairs."""
    run = timer or (lambda name, fn, *a: fn(*a))
    h_aff, h_inf = run("hash", _hash_graphs, u)
    rpk_aff, rpk_inf, ssum_aff, ssum_inf, flags_ok = run(
        "prep", _prep_graphs, pk_jac, sig_jac, scalars, real
    )
    gpk_aff, gpk_inf = run("group", _group_graphs, rpk_aff, rpk_inf, grid_idx, grid_real)
    fprod = run(
        "miller", _miller_graphs, gpk_aff, gpk_inf, h_aff, h_inf, ssum_aff, ssum_inf
    )
    return run("final", _final_graphs, fprod, flags_ok)


# --- host marshalling ----------------------------------------------------------


def _bucket(n: int, floor: int = 4) -> int:
    """Next power-of-two shape bucket with a floor of 4."""
    b = floor
    while b < n:
        b *= 2
    return b


def grid_bucket(n_b: int) -> int:
    """Aggregation-grid group-axis bucket: pinned to the set bucket."""
    return n_b


@dataclass
class Marshalled:
    """One marshalled batch: the device tensors of both staged paths (the
    grid is None on the per-set path) and host-side batch facts."""

    u: torch.Tensor
    h_idx: torch.Tensor
    pk: torch.Tensor
    sig: torch.Tensor
    scalars: torch.Tensor  # (n_b, 2) int64 words in [0, 2^32): (hi, lo)
    real: torch.Tensor
    grid_idx: torch.Tensor | None
    grid_real: torch.Tensor | None
    n_sets: int
    n_messages: int


def marshalled_from_numpy(arrays: dict, device) -> Marshalled:
    """Device tensors from the numpy fields of a marshalled batch in the
    `_tpu_limbs` layout (u, h_idx, pk, sig, scalars, real, grid_idx,
    grid_real; the grid may be None). Carries the JAX backend's batch
    across, and is this backend's own last marshalling step. The set and
    message counts come from the dict, else from the host arrays: no
    device value is read."""
    dev = resolve_device(device)
    host = {
        name: None if arrays.get(name) is None
        else np.asarray(arrays[name]).astype(dtype)
        for name, dtype in (
            ("u", np.int32), ("h_idx", np.int64), ("pk", np.int32),
            ("sig", np.int32), ("scalars", np.int64), ("real", np.bool_),
            ("grid_idx", np.int64), ("grid_real", np.bool_),
        )
    }
    n_sets = arrays.get("n_sets")
    n_messages = arrays.get("n_messages")
    t = {name: None if a is None else _to_device(a, dev) for name, a in host.items()}
    return Marshalled(
        **t,
        n_sets=int(host["real"].sum() if n_sets is None else n_sets),
        n_messages=int(host["u"].shape[0] if n_messages is None else n_messages),
    )


def _common_table(sets):
    """The shared pubkey table if EVERY pubkey in the batch is tagged with
    the same one (by the chain's validator pubkey cache), else None."""
    table = None
    for s in sets:
        for key in s.pubkeys:
            t = getattr(key, "table", None)
            if t is None:
                return None
            if table is None:
                table = t
            elif t is not table:
                return None
    return table


def _pack_index_batch(sets, n_b: int, k_b: int):
    """The (n_b, k_b) validator-index / pubkey-count mask pack of one fully
    table-tagged batch: the gather route's host loop."""
    idx = np.zeros((n_b, k_b), np.int32)
    mask = np.zeros((n_b, k_b), bool)
    for i, s in enumerate(sets):
        for j, key in enumerate(s.pubkeys):
            idx[i, j] = key.validator_index
        mask[i, : len(s.pubkeys)] = True
    return idx, mask


def prepack_indices(sets):
    """Pipeline pre-marshal hook: the gather route's (idx, mask) pack when
    EVERY pubkey in the batch is tagged with the same table, else None
    (the batch host-packs limb rows instead). Pure host work."""
    for s in sets:
        if not s.pubkeys or s.signature.point.inf:
            return None
    if _common_table(sets) is None:
        return None
    n_b = _bucket(len(sets))
    k_b = _bucket(max(len(s.pubkeys) for s in sets))
    return _pack_index_batch(sets, n_b, k_b)


def _marshal_batch(sets, device, seed=None, groups=None, index_pack=None,
                   pad_to=None):
    """Host-side marshalling for one batch: structural checks, shape
    bucketing, distinct-message grouping, limb packing or the device-table
    index gather, weights and -- when grouping collapses the bucketed
    pairs -- the aggregation grid. Returns None when a structural check
    already decides the batch.

    `groups` is an optional precomputed `aggregation.MessageGroups` and
    `index_pack` an optional precomputed `prepack_indices` result. `pad_to`
    raises the set bucket to a warmed capacity: n_b becomes at least
    `_bucket(pad_to)`, and when the message bucket lands strictly between
    the floor and n_b, m_b is forced to n_b (padded rows are masked
    infinities, so verdicts are unchanged). The grid is built only while
    `_msg_agg_enabled()`, and the host key_validate runs only while
    `_key_validate()`."""
    key_validate = _key_validate()
    for s in sets:
        if not s.pubkeys or s.signature.point.inf:
            return None
        if key_validate:
            # G1 key_validate: low-order components are pairing-invisible,
            # so this host check is the only gate
            for pk in s.pubkeys:
                if not _api().pubkey_subgroup_ok(pk):
                    return None

    dev = resolve_device(device)
    n = len(sets)
    k = max(len(s.pubkeys) for s in sets)
    n_b = _bucket(n)
    k_b = _bucket(k)
    if pad_to:
        n_b = max(n_b, _bucket(int(pad_to)))
        if index_pack is not None and index_pack[0].shape != (n_b, k_b):
            index_pack = None  # prepacked at the natural bucket; repack

    if groups is None:
        with tracing.span("bls_aggregate", sets=n):
            groups = AG.group_sets(sets)
    m = groups.n_messages
    h_idx = np.zeros((n_b,), np.int32)
    h_idx[:n] = groups.set_message
    m_b = _bucket(m)
    if pad_to and 4 < m_b < n_b:
        # the warm family only has m_b in {floor, n_b}
        m_b = n_b
    u = np.zeros((m_b, 2, 2, W), np.int32)
    for j, msg in enumerate(groups.messages):
        u[j] = _field_draws_cached(msg)

    sig = np.zeros((n_b, 3, 2, W), np.int32)
    sig[:, 1, 0, 0] = 1  # projective infinity on padded rows
    for i, s in enumerate(sets):
        sig[i] = _sig_limbs(s.signature)

    grid_idx = grid_real = None
    if _msg_agg_enabled() and m_b < n_b:
        grid_idx, grid_real = AG.group_grid(groups.members, m_b, grid_bucket(n_b))

    table = _common_table(sets)
    pk = None
    if table is None:
        metrics.BLS_GATHER_MISSES.inc()
        pk = np.broadcast_to(_INF_G1, (n_b, k_b, 3, W)).copy()
        for i, s in enumerate(sets):
            for j, key in enumerate(s.pubkeys):
                pk[i, j] = _pk_limbs(key)
        pk_traffic = (pk,)
    else:
        metrics.BLS_GATHER_HITS.inc()
        # steady state (validator_pubkey_cache.rs:10-23): the host ships
        # validator indices; limb rows come from the device-resident table
        idx, mask = index_pack if index_pack is not None else (
            _pack_index_batch(sets, n_b, k_b))
        pk_traffic = (idx, mask)

    scalars = _draw_weight_scalars(seed, n, n_b)
    real = np.zeros((n_b,), bool)
    real[:n] = True
    grid_traffic = () if grid_idx is None else (grid_idx, grid_real)
    _count_transfer(u, h_idx, sig, scalars, real, *grid_traffic, *pk_traffic)
    mb = marshalled_from_numpy(
        dict(
            u=u, h_idx=h_idx, pk=pk, sig=sig, scalars=scalars, real=real,
            grid_idx=grid_idx, grid_real=grid_real, n_sets=n, n_messages=m,
        ),
        dev,
    )
    if table is not None:
        rows = table.gather(idx)
        if rows.device != dev:
            raise ValueError(
                f"pubkey table on {rows.device}, batch marshalled for {dev}")
        mb.pk = torch.where(
            _to_device(mask, dev)[..., None, None], rows, L.on(_INF_G1, dev),
        )
    return mb


def _api():
    from .. import api

    return api


def _msg_agg_enabled() -> bool:
    """Message aggregation (the mega-pairing) is ON unless explicitly
    disabled (LIGHTHOUSE_TPU_MSG_AGG=0); read per call so tests flip it
    without reimport."""
    return os.environ.get("LIGHTHOUSE_TPU_MSG_AGG", "1") != "0"


def _monolith_enabled() -> bool:
    """The monolithic program (every batch through `verify_body` as one
    graph) is OFF unless LIGHTHOUSE_TPU_MONOLITH=1; read per call, as the
    JAX backend reads it."""
    return os.environ.get("LIGHTHOUSE_TPU_MONOLITH") == "1"


def _key_validate() -> bool:
    return _api().key_validate_enabled()


def _count_transfer(*arrays) -> None:
    """Host->device traffic of one batch (the numpy arrays actually
    shipped; the gather route ships indices, not limb rows)."""
    total = sum(int(a.nbytes) for a in arrays)
    metrics.TPU_TRANSFER_BYTES.inc(total)
    metrics.TPU_MARSHAL_BATCH_BYTES.set(total)


def _draw_weight_scalars(seed, n: int, n_b: int, rng=None) -> np.ndarray:
    """Per-dispatch random-linear-combination weights: (n_b, 2) uint32
    halves per set, the same numpy draws as the JAX backend for the same
    seed. `| 1` on the second half makes every real weight nonzero; a
    64-bit weight that collides with another in the batch is redrawn (two
    equal weights would let a forged pair cancel)."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    scalars = np.zeros((n_b, 2), np.uint32)
    if n:
        scalars[:n, 0] = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        scalars[:n, 1] = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) | 1
        w = scalars[:n, 0].astype(np.uint64) | (
            scalars[:n, 1].astype(np.uint64) << np.uint64(32)
        )
        while True:
            _, first = np.unique(w, return_index=True)
            dup = np.ones(n, bool)
            dup[first] = False
            d = int(dup.sum())
            if not d:
                break
            metrics.BLS_WEIGHT_REDRAWS.inc(d)
            lo = rng.integers(0, 1 << 32, size=d, dtype=np.uint32)
            hi = rng.integers(0, 1 << 32, size=d, dtype=np.uint32) | 1
            scalars[:n][dup, 0] = lo
            scalars[:n][dup, 1] = hi
            w[dup] = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return scalars


# --- entry points --------------------------------------------------------------


def run_marshalled(mb: Marshalled, timer=None, monolith=False) -> torch.Tensor:
    """The device verify of one marshalled batch: with `monolith`, the
    per-set draws (expanded by `h_idx` on the device, outside the graph,
    as the JAX backend takes them outside `verify_jit`) through
    `verify_body` as one graph, the grid ignored; else staged, the
    aggregated path when the batch carries a grid, else the per-set path.
    Returns a zero-dim bool tensor on the batch's device (no host sync)."""
    if monolith:
        run = timer or (lambda name, fn, *a: fn(*a))
        return run("monolith", _monolith_graphs, mb.u[mb.h_idx], mb.pk, mb.sig,
                   mb.scalars, mb.real)
    if mb.grid_idx is not None:
        return verify_device_aggregated(
            mb.u, mb.pk, mb.sig, mb.scalars, mb.real, mb.grid_idx, mb.grid_real,
            timer=timer,
        )
    return verify_device(
        mb.u, mb.h_idx, mb.pk, mb.sig, mb.scalars, mb.real, timer=timer
    )


def _count_pairs(n_sets: int, pairs: int, aggregated: bool) -> None:
    """The pairing-cost telemetry of one dispatched batch: Miller-pair
    count (the latency driver the aggregation attacks) and sets-per-pair
    aggregation ratio (1.0-ish unaggregated; ~n/m on the mega-pairing)."""
    metrics.BLS_MILLER_PAIRS.inc(pairs)
    metrics.BLS_MILLER_PAIRS_LAST.set(pairs)
    metrics.BLS_AGGREGATION_RATIO.set(n_sets / pairs)
    if aggregated:
        metrics.BLS_AGGREGATED_BATCHES.inc()


def dispatch_verify_signature_sets(sets, seed=None, groups=None, index_pack=None,
                                   pad_to=None, device=None):
    """Marshal + enqueue, no host sync: a zero-dim device bool, or a plain
    False when a structural check already decided the batch. The keywords
    are the pipeline/scheduler duck type: precomputed message `groups`,
    the gather route's `index_pack`, `pad_to`, and the `device`. Under
    LIGHTHOUSE_TPU_MONOLITH=1 every batch, aggregated ones too, takes the
    per-set monolith (n_b + 1 Miller pairs)."""
    with tracing.span("bls_marshal", sets=len(sets)):
        mb = _marshal_batch(sets, device, seed=seed, groups=groups,
                            index_pack=index_pack, pad_to=pad_to)
    if mb is None:
        return False
    n_b = int(mb.real.shape[0])
    monolith = _monolith_enabled()
    aggregated = mb.grid_idx is not None and not monolith
    # the aggregated path's Miller pairs ride the message bucket
    pairs = (int(mb.u.shape[0]) if aggregated else n_b) + 1
    new_key = _count_shape_bucket(*_shape_bucket(mb))
    with tracing.span("bls_dispatch", bucket=n_b):
        _count_pairs(mb.n_sets, pairs, aggregated=aggregated)
        out = run_marshalled(mb, monolith=monolith)
    launch_ledger.record(
        "dispatch",
        bucket=n_b,
        real_sets=mb.n_sets,
        padded_sets=n_b,
        n_messages=mb.n_messages,
        miller_pairs=pairs,
        cache_hit=new_key is None,
    )
    return out


def verify_signature_sets(sets, seed=None, device=None) -> bool:
    return bool(dispatch_verify_signature_sets(sets, seed=seed, device=device))


def aggregate_verify(signature, pubkeys, messages, device=None, timer=None) -> bool:
    """prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1 (reference
    generic_aggregate_signature.rs aggregate_verify) through the batch
    verifier's hash, Miller and final stages: `_stage_miller`'s pair layout
    (one G1 point per row plus the generator pair, one G2 point per row
    plus one trailing G2 point) is the aggregate's pair structure, so only
    `_stage_agg_prep` is its own. The structural verdicts (lengths, empty,
    infinity signature) are the api layer's. `timer` as in verify_device."""
    if _key_validate():
        for pk in pubkeys:
            if not _api().pubkey_subgroup_ok(pk):
                return False
    dev = resolve_device(device)
    run = timer or (lambda name, fn, *a: fn(*a))
    k = len(pubkeys)
    k_b = _bucket(k)
    u = np.zeros((k_b, 2, 2, W), np.int32)
    pk = np.broadcast_to(_INF_G1, (k_b, 3, W)).copy()
    for i, (key, msg) in enumerate(zip(pubkeys, messages)):
        u[i] = _field_draws_cached(bytes(msg))
        pk[i] = _pk_limbs(key)
    real = np.zeros((k_b,), bool)
    real[:k] = True
    real = _to_device(real, dev)
    pk_aff, pk_inf, sig_aff, sig_inf, sig_ok = run(
        "agg_prep", _agg_prep_graphs, _to_device(pk, dev),
        _to_device(_sig_limbs(signature), dev), real,
    )
    h_aff, h_inf = run("hash", _hash_graphs, _to_device(u, dev))
    fprod = run(
        "miller", _miller_graphs, pk_aff, pk_inf, h_aff, h_inf | ~real,
        sig_aff, sig_inf,
    )
    return bool(run("final", _final_graphs, fprod, sig_ok))


# --- stage graphs: the bucket registry and the warm pass ---------------------

# bucketed shapes run so far: the observable face of the stage graphs'
# per-shape cache (a new bucket captures, a seen one replays)
_seen_shape_buckets: set[tuple] = set()


def _shape_bucket(mb: Marshalled) -> tuple:
    """(n_b, k_b, m_b, g_b) of a marshalled batch; g_b = 0 on the per-set
    path, the grid's group axis on the aggregated one."""
    n_b, k_b = mb.pk.shape[:2]
    g_b = 0 if mb.grid_idx is None else mb.grid_idx.shape[1]
    return n_b, k_b, mb.u.shape[0], g_b


def _count_shape_bucket(n_b: int, k_b: int, m_b: int, g_b: int = 0):
    """Register a batch's bucketed shape on tpu_compile_cache_{hits,
    misses}_total; returns the key when it is new in this process (its
    stages are captured now), else None. In-process only, without the
    JAX backend's disk registry: a CUDA graph does not outlive its
    process, so there is nothing to persist."""
    key = (n_b, k_b, m_b, g_b)
    if key in _seen_shape_buckets:
        metrics.TPU_COMPILE_CACHE_HITS.inc()
        return None
    _seen_shape_buckets.add(key)
    metrics.TPU_COMPILE_CACHE_MISSES.inc()
    return key


# The shape families a fresh node sees in steady state, as the JAX
# backend warms them: gossip batches (<= 64 sets, mostly distinct
# messages -> m_b == n_b, per-set path) and aggregate/backfill batches
# (repeated messages -> m_b at the floor, aggregated path); k_b at the
# bucket floor for the dominant 1-pubkey sets.
DEFAULT_WARM_BUCKETS: tuple = tuple(
    sorted({(n_b, 4, m_b) for n_b in (4, 16, 64, 256, 512) for m_b in (4, n_b)})
)


def warm_compile(buckets=None, runner=None, device=None):
    """Capture the stage graphs of every (n_b, k_b, m_b) bucket in
    `buckets` before the first slot, as the JAX backend's warm_compile
    compiles them: each bucket drives the route the dispatcher takes --
    the aggregated path when message aggregation is on and m_b < n_b,
    else the per-set path (no mesh yet) -- with an all-padding batch
    (projective infinities, zero weights, no real set), since a graph is
    keyed by shapes alone.

    `runner(kind, args)` is injectable for the tests (kind "staged" or
    "aggregated"); the default runs the route twice on `device` (the card
    unless the caller asks for the CPU) -- the first call at a shape
    captures, the second replays -- and blocks until both have run.
    Returns [{"bucket": (n_b, k_b, m_b, g_b), "seconds": s, "compiled":
    the bucket was new in this process}]."""
    dev = resolve_device(device)
    if buckets is None:
        buckets = DEFAULT_WARM_BUCKETS
    if runner is None:
        def runner(kind, args):
            route = verify_device_aggregated if kind == "aggregated" else verify_device
            for _ in range(2):
                bool(route(*args))

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    report = []
    for n_b, k_b, m_b in buckets:
        aggregated = _msg_agg_enabled() and m_b < n_b
        g_b = grid_bucket(n_b) if aggregated else 0
        u = zeros((m_b, 2, 2, W))
        pk = L.on(_INF_G1, dev).expand(n_b, k_b, 3, W).clone()
        sig = zeros((n_b, 3, 2, W))
        sig[:, 1, 0, 0] = 1
        scalars = zeros((n_b, 2), torch.int64)
        real = zeros((n_b,), torch.bool)
        new_key = _count_shape_bucket(n_b, k_b, m_b, g_b)
        t0 = time.perf_counter()
        if aggregated:
            runner("aggregated", (u, pk, sig, scalars, real,
                                  zeros((m_b, g_b), torch.int64),
                                  zeros((m_b, g_b), torch.bool)))
        else:
            runner("staged", (u, zeros((n_b,), torch.int64), pk, sig, scalars, real))
        seconds = time.perf_counter() - t0
        key = "x".join(str(v) for v in (n_b, k_b, m_b, g_b))
        metrics.TPU_WARM_COMPILE_SECONDS.set(key, seconds)
        launch_ledger.record(
            "warm",
            bucket=key,
            real_sets=0,  # warm batches are all padding by construction
            padded_sets=n_b,
            compile_seconds=seconds,
            cache_hit=new_key is None,
        )
        report.append({"bucket": (n_b, k_b, m_b, g_b),
                       "seconds": seconds,
                       "compiled": new_key is not None})
    return report


# --- device-resident pubkey table ---------------------------------------------


class PubkeyTable:
    """Decompressed validator pubkeys resident on one device, keyed by
    validator index: the port of jax_tpu.PubkeyTable, the analogue of the
    reference's ValidatorPubkeyCache (validator_pubkey_cache.rs:10-23,131).
    Upload once per import of new validators; per-batch traffic is
    indices. The table lives on `device` (the card unless the caller asks
    for the CPU).

    The JAX table shards its validator axis over a device mesh past a size
    floor; that branch waits for the port's mesh (ROADMAP Queue 1), so
    this table is always whole on its one device.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._host = np.zeros((0, 3, W), np.int32)
        self._dev = None

    def __len__(self) -> int:
        return self._host.shape[0]

    def import_new_pubkeys(self, pubkeys) -> None:
        """Append validated pubkeys (validator_pubkey_cache.rs:79). Every
        key passes key_validate (on curve, in the subgroup, not infinity)
        before any limb row is packed; the whole import is refused with
        BlsError on the first bad key, and the table is left unchanged
        (unless LIGHTHOUSE_TPU_KEY_VALIDATE=0)."""
        if not pubkeys:
            return
        pubkeys = list(pubkeys)
        if _key_validate():
            for i, pk in enumerate(pubkeys):
                try:
                    ok = _api().pubkey_subgroup_ok(pk)
                except Exception:  # noqa: BLE001 -- malformed key object
                    ok = False
                if not ok:
                    raise _api().BlsError(
                        f"pubkey table import refused: key {i} failed "
                        "key_validate (malformed, infinity, or outside the "
                        "r-torsion subgroup)"
                    )
        rows = np.stack([_pk_limbs(pk) for pk in pubkeys])
        self._host = np.concatenate([self._host, rows], axis=0)
        self._dev = None  # re-upload lazily

    def device_table(self) -> torch.Tensor:
        """The (b, 3, W) int32 table on the device, b = _bucket(n, floor=8);
        padding rows are G1 infinity."""
        if self._dev is None:
            n = len(self._host)
            b = _bucket(max(n, 1), floor=8)
            padded = np.broadcast_to(_INF_G1, (b, 3, W)).copy()
            padded[:n] = self._host
            self._dev = _to_device(padded, self.device)
            metrics.TPU_PUBKEY_TABLE_BYTES.set(str(self.device), padded.nbytes)
        return self._dev

    def gather(self, indices) -> torch.Tensor:
        """Validator indices (any shape) -> (..., 3, W) rows on the device.
        Out-of-range indices clip to the nearest bucketed row, as
        jnp.take(mode="clip") does (marshalling masks them anyway)."""
        table = self.device_table()
        if isinstance(indices, torch.Tensor) and indices.device.type != "cpu":
            idx = indices.to(self.device, torch.int64)
        else:  # host indices, a CPU tensor too, go through pinned memory
            idx = _to_device(np.asarray(indices, np.int64), self.device)
        metrics.TPU_PUBKEY_GATHER_BATCHES.inc()
        metrics.TPU_PUBKEY_GATHER_BYTES.inc(idx.numel() * 3 * W * 4)
        return table[idx.clamp(0, table.shape[0] - 1)]


# --- speculative verification: committee aggregate residency ----------------
#
# speculate/ precomputes one aggregate pubkey per (slot, committee) at the
# epoch boundary. Those keys live here, in a device table next to the
# validator PubkeyTable, and `correct_aggregate_device` subtracts a
# committee's absent members from its cached full aggregate on the device.

_committee_table: PubkeyTable | None = None


def committee_table(device=None) -> PubkeyTable:
    """The committee-aggregate table (empty on `device` until
    `set_committee_aggregates` fills it)."""
    global _committee_table
    if _committee_table is None:
        _committee_table = PubkeyTable(device)
    return _committee_table


def set_committee_aggregates(pubkeys, device=None) -> None:
    """Replace the device-resident committee-aggregate family with a fresh
    table on `device` (the card unless the caller asks for the CPU; per
    precompute refresh: entries are epoch-scoped, so the table is rebuilt,
    not grown). Also caches each key's `_tpu_limbs`."""
    global _committee_table
    table = PubkeyTable(device)
    table.import_new_pubkeys(list(pubkeys))
    _committee_table = table
    if len(table):
        b = _bucket(len(table), floor=8)
        metrics.SPECULATE_TABLE_BYTES.set(b * 3 * W * 4)


def _speculate_device_enabled() -> bool:
    """The device correction is OFF unless LIGHTHOUSE_TPU_SPECULATE_DEVICE
    is set to anything but "0"; read per call."""
    return os.environ.get("LIGHTHOUSE_TPU_SPECULATE_DEVICE", "0") != "0"


def _stage_correct(full, absent, absent_real):
    """full (3, W) projective aggregate; absent (k_b, 3, W) padded member
    points with a (k_b,) real mask -> affine corrected point
    (full - sum(absent)) and its infinity flag."""
    F = TC.FP
    masked = TC.point_select(
        absent_real, absent, TC.infinity(F, absent.shape[:1], absent.device), F)
    s = TC.sum_points(masked, F)
    corrected = TC.add(full, TC.neg(s, F), F)
    aff, inf = TC.to_affine_g1(corrected[None])
    return aff[0], inf[0]


_correct_graphs = graphed(_stage_correct)


def correct_aggregate_device(full_pk, absent_pks, device=None):
    """The cached full-committee aggregate minus the absent members'
    points, on `device` (the card unless the caller asks for the CPU), as
    one graph per bucket of the absent count. Returns an oracle affine
    Point, or None when the result is infinity (all members absent; the
    caller aggregates on the host). The verdict's host read is part of
    the API, as in the JAX backend."""
    dev = resolve_device(device)
    k = len(absent_pks)
    k_b = _bucket(max(k, 1))
    absent = np.broadcast_to(_INF_G1, (k_b, 3, W)).copy()
    for i, pk in enumerate(absent_pks):
        absent[i] = _pk_limbs(pk)
    real = np.zeros(k_b, bool)
    real[:k] = True
    aff, inf = _correct_graphs(
        _to_device(_pk_limbs(full_pk), dev), _to_device(absent, dev),
        _to_device(real, dev))
    if bool(inf):
        return None
    aff = aff.cpu().numpy()
    return Point(Fp(L.to_int(aff[0])), Fp(L.to_int(aff[1])), False)
