"""Pure-Python CPU verification backend (the milagro-equivalent fallback,
reference crypto/bls/src/impls/milagro.rs): a copy of
lighthouse_tpu/crypto/bls/backends/cpu.py whose entry points accept the
port's `device=` keyword and ignore it.

Same random-linear-combination batch semantics as the GPU backend, executed
with the oracle pairing: one multi-Miller-loop product and one final
exponentiation for the whole batch (reference impls/blst.rs:36-119).

Message-aggregated like the GPU path (crypto/bls/aggregation.py derives
the identity): after each set's own random weight is applied, the
weighted aggregate pubkeys of sets sharing a message collapse into ONE
G1 point, so the oracle pays m + 1 Miller loops for m distinct messages
instead of n + 1 for n sets -- the fallback keeps the mega-pairing's
cost shape AND its accept/reject semantics, which is what makes it a
drop-in degradation target for the torch_cuda aggregated path.
"""

from __future__ import annotations

import random

from ....utils import metrics as M
from .. import curve_ref as C
from .. import pairing_ref as PR
from ..hash_to_curve_ref import hash_to_g2


def _set_checks(s) -> C.Point | None:
    """Per-set structural checks; returns the aggregate pubkey or None."""
    if not s.pubkeys:
        return None
    if s.signature.point.inf:
        return None
    if not C.g2_subgroup_check_psi(s.signature.point):
        return None
    if _key_validate():
        # G1-side key_validate (blst's analogue runs at decompression):
        # a pubkey with a low-order cofactor component pairs EXACTLY like
        # its r-torsion part — e(T, Q) == 1 for cofactor-order T — so the
        # pairing product cannot reject it; only this check can. Cached
        # per object: keys from PublicKey.from_bytes answer for free.
        from .. import api

        for pk in s.pubkeys:
            if not api.pubkey_subgroup_ok(pk):
                return None
    agg = None
    for pk in s.pubkeys:
        agg = pk.point if agg is None else agg + pk.point
    if agg.inf:
        return None
    return agg


def _key_validate() -> bool:
    from .. import api

    return api.key_validate_enabled()


def _draw_weights(seed, n: int, rng: random.Random | None = None) -> list[int]:
    """Per-DISPATCH random-linear-combination weights: n 64-bit values,
    each nonzero (blst.rs:45-57) and pairwise-distinct within the batch.
    A zero weight voids its set's pairing contribution and a colliding
    pair lets two forged sets cancel each other, so degenerate draws are redrawn and
    counted on bls_weight_redraws_total. `rng` is injectable so tests can
    force collisions deterministically."""
    rng = rng if rng is not None else random.Random(seed)
    out: list[int] = []
    used: set[int] = set()
    for _ in range(n):
        r = rng.getrandbits(64) | 1
        while r in used:
            M.BLS_WEIGHT_REDRAWS.inc()
            r = rng.getrandbits(64) | 1
        used.add(r)
        out.append(r)
    return out


def verify_signature_sets(sets, seed=None, device=None) -> bool:
    weights = _draw_weights(seed, len(sets))
    group_pk: dict[bytes, C.Point] = {}
    order: list[bytes] = []
    sig_acc = None
    for s, r in zip(sets, weights):
        agg_pk = _set_checks(s)
        if agg_pk is None:
            return False
        # per-set weight FIRST, then per-message grouping: the weight is
        # drawn after the adversary commits to the set, so a forged set
        # cannot cancel an honest one inside its message group
        weighted_pk = agg_pk.mul(r)
        msg = bytes(s.message)
        if msg in group_pk:
            group_pk[msg] = group_pk[msg] + weighted_pk
        else:
            group_pk[msg] = weighted_pk
            order.append(msg)
        weighted = s.signature.point.mul(r)
        sig_acc = weighted if sig_acc is None else sig_acc + weighted
    pairs = [(group_pk[m], hash_to_g2(m)) for m in order]
    pairs.append((-C.g1_generator(), sig_acc))
    return PR.multi_pairing(pairs) == PR.Fp12.one()


def aggregate_verify(signature, pubkeys, messages, device=None) -> bool:
    """ONE aggregate signature over DISTINCT messages (reference
    generic_aggregate_signature.rs aggregate_verify):
    prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1."""
    # structural checks (lengths, empty, infinity) live in the api layer
    if not C.g2_subgroup_check_psi(signature.point):
        return False
    if _key_validate():
        from .. import api

        for pk in pubkeys:
            if not api.pubkey_subgroup_ok(pk):
                return False
    pairs = [
        (pk.point, hash_to_g2(bytes(m))) for pk, m in zip(pubkeys, messages)
    ]
    pairs.append((-C.g1_generator(), signature.point))
    return PR.multi_pairing(pairs) == PR.Fp12.one()
