"""Aggregation-soundness adversary layer for the PyTorch/CUDA port:
seeded forgery constructors and a differential rejection matrix over the
port's verification paths.

A copy of lighthouse_tpu/crypto/bls/adversary.py over the port's api,
curve, field, hash-to-curve and pairing oracles and backends: the same
constructors give the same pubkey, signature and message bytes for one
(family, seed). The probes check what a port of batched random-linear-
combination verification most easily gets wrong:

* **rogue-key** -- an adversarial pubkey ``P_adv = Q - P_target`` makes
  the naive aggregate collapse to the attacker-controlled ``Q``. The
  rogue key IS a valid r-torsion point, so key_validate cannot reject
  it: the defense is that verification only ever aggregates registry-
  bound pubkeys. The probes assert the rogue signature is rejected
  whenever it is attributed to the honest committee, and
  ``rogue_key_feasibility_sets`` shows the attack succeeding when the
  rogue key is smuggled INTO the claimed signer set.
* **weight-collision** -- pairs of forged sets whose tampered signature
  components cancel inside the linear combination iff two batch weights
  collide (equal, related by a small factor, or zero). Sound per-
  dispatch weight draws reject them with probability 1 - 2^-64; the
  weakened verifiers below accept them under planted degenerate draws,
  proving the probes have teeth.
* **subgroup / small-order** -- on-curve points outside the r-torsion.
  The G1 low-order-component probe is the sharp one: ``e(T, Q) == 1``
  for any cofactor-order ``T``, so a pubkey ``P + T`` pairs EXACTLY like
  ``P`` and only an explicit key_validate (api.pubkey_subgroup_ok at the
  cpu set checks, the torch_cuda marshal seam, and the PubkeyTable
  import) rejects it. G2-side probes ride the signature subgroup checks.
* **grouping-cancellation** -- forged sets sharing one message whose
  tampered components cancel only if the grouped mega-pairing applied a
  single weight per MESSAGE GROUP instead of per set. The sound order
  (weight first, then group: backends/cpu.py, torch_cuda `_stage_prep`
  then `_stage_group`) rejects; ``weakened_verify_group_then_weight``
  shows the bug being caught.
* **speculation-poisoning** -- valid-but-different signatures and stale
  shuffling keys replayed at the confirm-by-lookup seam of speculate/
  (``SpeculativeVerifier.confirm``): ``speculation_poison_material``
  builds the material, and ``audit`` drives the seam with it.

Everything is seeded and deterministic: ``random.Random(f"{family}:{
seed}")`` drives each constructor, so a probe batch is a pure function
of (family, seed) and any finding replays bit-identically.

``rejection_matrix`` runs one batch through the port's paths (the cpu
oracle; torch_cuda per-set and message-aggregated, each with its
routing switch pinned; the mesh grouped body, which raises until the
port has a mesh; the FallbackBackend over a primary that fails mid-trip)
and returns the per-path verdicts; ``audit`` is the cpu-oracle subset.
The torch paths run on the card unless the caller passes
``device="cpu"``."""

from __future__ import annotations

import os
import random
from contextlib import contextmanager

from . import curve_ref as C
from .api import PublicKey, SecretKey, Signature, SignatureSet
from .constants import R
from .fields_ref import Fp
from .hash_to_curve_ref import hash_to_field_fp2, hash_to_g2, map_to_curve_g2

PATHS = (
    "cpu",
    "torch_per_set",
    "torch_aggregated",
    "mesh_grouped",
    "fallback",
)

FAMILIES = (
    "rogue-key",
    "weight-collision",
    "subgroup",
    "grouping-cancellation",
    "speculation-poisoning",
)


# -- deterministic adversarial material ---------------------------------------


def _rng(family: str, seed: int) -> random.Random:
    # str seeding hashes with sha512 (random.seed version 2): stable
    # across processes and python versions, unlike hash()-based seeding
    return random.Random(f"{family}:{seed}")


def _sk(rng: random.Random) -> SecretKey:
    return SecretKey(rng.randrange(1, R))


def _msg(rng: random.Random) -> bytes:
    return rng.randbytes(32)


_NON_SUBGROUP_G1: C.Point | None = None


def non_subgroup_g1_point() -> C.Point:
    """Deterministic on-curve G1 point OUTSIDE the r-torsion: brute-force
    the smallest x whose curve point fails the subgroup check (the
    edge-matrix recipe; x = 4 on BLS12-381)."""
    global _NON_SUBGROUP_G1
    if _NON_SUBGROUP_G1 is None:
        x = 1
        while True:
            rhs = Fp(x) * Fp(x) * Fp(x) + Fp(4)
            y = rhs.sqrt()
            if y is not None:
                p = C.Point(Fp(x), y)
                if not C.g1_subgroup_check(p):
                    _NON_SUBGROUP_G1 = p
                    break
            x += 1
    return _NON_SUBGROUP_G1


_LOW_ORDER_G1: C.Point | None = None


def low_order_g1_point() -> C.Point:
    """A nonzero G1 cofactor-subgroup point ``T = [r]P_ns``: order divides
    h1 (coprime to r), so ``e(T, Q) == 1`` for every Q — adding T to any
    pubkey is invisible to the pairing product and only key_validate can
    reject the result."""
    global _LOW_ORDER_G1
    if _LOW_ORDER_G1 is None:
        T = non_subgroup_g1_point().mul(R)
        assert not T.inf and not C.g1_subgroup_check(T)
        _LOW_ORDER_G1 = T
    return _LOW_ORDER_G1


def non_subgroup_g2_point(tag: bytes = b"adversary-g2") -> C.Point:
    """On-curve G2 point outside the r-torsion: the SSWU map BEFORE
    cofactor clearing (hash_to_g2 without clear_cofactor_g2)."""
    u = hash_to_field_fp2(tag, 1)[0]
    return map_to_curve_g2(u)


def _g2_delta(tag: bytes, k: int = 3) -> C.Point:
    """A G2 SUBGROUP point usable as a cancellation component: it passes
    every signature subgroup check, so only sound weights reject a batch
    whose tampered signatures carry ±delta."""
    return hash_to_g2(tag).mul(k)


def honest_sets(
    seed: int, n_sets: int = 4, n_messages: int = 2, pubkeys_per_set: int = 1
) -> list[SignatureSet]:
    """A valid control batch with REPEATED messages (n_messages <
    n_sets), so the aggregated mega-pairing grid and the mesh grouped
    body both engage — the matrix's accept-side sanity check."""
    rng = _rng("honest", seed)
    msgs = [_msg(rng) for _ in range(n_messages)]
    out = []
    for i in range(n_sets):
        msg = msgs[i % n_messages]
        sks = [_sk(rng) for _ in range(pubkeys_per_set)]
        sig = sks[0].sign(msg).point
        for sk in sks[1:]:
            sig = sig + sk.sign(msg).point
        out.append(
            SignatureSet.multiple_pubkeys(
                Signature(sig), [sk.public_key() for sk in sks], msg
            )
        )
    return out


def _with_fillers(forged: list[SignatureSet], seed: int) -> list[SignatureSet]:
    """Pad a forged set list with honest sets REUSING the forged sets'
    messages where possible: the batch repeats messages, so the
    aggregated/mesh grouped paths engage, and the only rejection cause
    is the forgery (batch verification is all-or-nothing)."""
    rng = _rng("filler", seed)
    msgs = list(dict.fromkeys(bytes(s.message) for s in forged))
    while len(msgs) < 2:
        msgs.append(_msg(rng))
    out = list(forged)
    for i in range(max(0, 5 - len(out))):
        sk = _sk(rng)
        msg = msgs[i % len(msgs)]
        out.append(SignatureSet.single_pubkey(sk.sign(msg), sk.public_key(), msg))
    return out


# -- probe families -----------------------------------------------------------


def rogue_key_batches(seed: int = 0) -> list[list[SignatureSet]]:
    """Rogue signature (signed under the attacker's ``Q``) attributed to
    the honest registry-bound committee. Verification only ever
    aggregates the committee's OWN keys (the precompute substitutes a
    mathematically identical point), so the pairing sees ``e(P_t + P_o,
    H(m))`` against ``e(g1, q·H(m))`` and must reject on every path."""
    rng = _rng("rogue-key", seed)
    target, other, attacker = _sk(rng), _sk(rng), _sk(rng)
    msg = _msg(rng)
    rogue_sig = attacker.sign(msg)
    claimed_pair = SignatureSet.multiple_pubkeys(
        rogue_sig, [target.public_key(), other.public_key()], msg
    )
    claimed_single = SignatureSet.single_pubkey(
        rogue_sig, target.public_key(), msg
    )
    return [
        _with_fillers([claimed_pair], seed),
        _with_fillers([claimed_single], seed + 1),
    ]


def rogue_key_feasibility_sets(seed: int = 0) -> list[SignatureSet]:
    """The attack the family exists for — and the reason the import seam
    must stay registry-bound: with ``P_adv = Q - P_target`` smuggled INTO
    the claimed signer set, the aggregate collapses to ``Q`` and plain
    aggregate verification ACCEPTS the attacker's lone signature. P_adv
    is a perfectly valid r-torsion point (key_validate passes); only the
    deposit seam's proof-of-possession prevents it from ever being bound
    to a validator index."""
    rng = _rng("rogue-key", seed)
    target, _other, attacker = _sk(rng), _sk(rng), _sk(rng)
    msg = _msg(rng)
    p_adv = PublicKey(
        attacker.public_key().point + (-target.public_key().point),
        subgroup_checked=True,  # genuinely in G1: difference of members
    )
    return [
        SignatureSet.multiple_pubkeys(
            attacker.sign(msg), [target.public_key(), p_adv], msg
        )
    ]


def weight_collision_batches(seed: int = 0) -> list[list[SignatureSet]]:
    """Forged pairs that cancel inside the linear combination iff two
    weights are EQUAL (batch 0), RELATED by a factor of two (batch 1),
    or a single forged set whose contribution vanishes iff its weight is
    ZERO (batch 2). Sets span DISTINCT messages, so the cancellation
    happens in the weighted signature sum alone — the probe that
    separates per-set weight soundness from grouping soundness."""
    rng = _rng("weight-collision", seed)
    a, b = _sk(rng), _sk(rng)
    m1, m2 = _msg(rng), _msg(rng)
    delta = _g2_delta(b"weight-collision:" + seed.to_bytes(4, "big"))
    s1, s2 = a.sign(m1).point, b.sign(m2).point

    equal_pair = [
        SignatureSet.single_pubkey(Signature(s1 + delta), a.public_key(), m1),
        SignatureSet.single_pubkey(Signature(s2 + (-delta)), b.public_key(), m2),
    ]
    related_pair = [
        # cancels iff r_second == 2 * r_first
        SignatureSet.single_pubkey(
            Signature(s1 + delta.double()), a.public_key(), m1
        ),
        SignatureSet.single_pubkey(Signature(s2 + (-delta)), b.public_key(), m2),
    ]
    zero_single = [
        SignatureSet.single_pubkey(Signature(s1 + delta), a.public_key(), m1)
    ]
    return [
        _with_fillers(equal_pair, seed),
        _with_fillers(related_pair, seed + 1),
        _with_fillers(zero_single, seed + 2),
    ]


def subgroup_batches(seed: int = 0) -> list[list[SignatureSet]]:
    """On-curve, out-of-torsion material at every seam a point can enter
    a batch: a low-order COMPONENT on a pubkey (pairing-invisible — the
    key_validate probe), a wholly non-subgroup pubkey, an infinity
    pubkey hidden among valid ones, a low-order component on a
    signature, and a wholly non-subgroup signature."""
    rng = _rng("subgroup", seed)
    sk = _sk(rng)
    msg = _msg(rng)
    sig = sk.sign(msg)
    T = low_order_g1_point()

    poisoned_pk = [
        SignatureSet.single_pubkey(
            sig, PublicKey(sk.public_key().point + T), msg
        )
    ]
    non_subgroup_pk = [
        SignatureSet.single_pubkey(sig, PublicKey(non_subgroup_g1_point()), msg)
    ]
    sk2 = _sk(rng)
    infinity_pk_mixed = [
        SignatureSet.multiple_pubkeys(
            Signature(sig.point + sk2.sign(msg).point),
            [
                sk.public_key(),
                PublicKey(C.Point(Fp.zero(), Fp.zero(), True)),
                sk2.public_key(),
            ],
            msg,
        )
    ]
    t2 = non_subgroup_g2_point(b"adversary-low-order-g2").mul(R)
    poisoned_sig = [
        SignatureSet.single_pubkey(Signature(sig.point + t2), sk.public_key(), msg)
    ]
    non_subgroup_sig = [
        SignatureSet.single_pubkey(
            Signature(non_subgroup_g2_point()), sk.public_key(), msg
        )
    ]
    return [
        _with_fillers(poisoned_pk, seed),
        _with_fillers(non_subgroup_pk, seed + 1),
        _with_fillers(infinity_pk_mixed, seed + 2),
        _with_fillers(poisoned_sig, seed + 3),
        _with_fillers(non_subgroup_sig, seed + 4),
    ]


def grouping_cancellation_batches(seed: int = 0) -> list[list[SignatureSet]]:
    """Two forged sets sharing ONE message whose ±delta components cancel
    only if the verifier aggregated the message group FIRST and weighted
    it as a unit. Run against the mega-pairing grid, the mesh grouped
    reduction, and the cpu oracle's identical grouping — the sound order
    (per-set weight, then group) leaves ``(r_a - r_b)·delta`` standing."""
    rng = _rng("grouping-cancellation", seed)
    a, b = _sk(rng), _sk(rng)
    msg = _msg(rng)
    delta = _g2_delta(b"grouping:" + seed.to_bytes(4, "big"))
    pair = [
        SignatureSet.single_pubkey(
            Signature(a.sign(msg).point + delta), a.public_key(), msg
        ),
        SignatureSet.single_pubkey(
            Signature(b.sign(msg).point + (-delta)), b.public_key(), msg
        ),
    ]
    # a three-set ring on one message: components cancel only under a
    # single shared group weight (sum of deltas is zero)
    c = _sk(rng)
    d2 = _g2_delta(b"grouping-ring:" + seed.to_bytes(4, "big"), k=5)
    ring = [
        SignatureSet.single_pubkey(
            Signature(a.sign(msg).point + delta), a.public_key(), msg
        ),
        SignatureSet.single_pubkey(
            Signature(b.sign(msg).point + d2), b.public_key(), msg
        ),
        SignatureSet.single_pubkey(
            Signature(c.sign(msg).point + (-(delta + d2))), c.public_key(), msg
        ),
    ]
    return [_with_fillers(pair, seed), _with_fillers(ring, seed + 1)]


BATCHES = {
    "rogue-key": rogue_key_batches,
    "weight-collision": weight_collision_batches,
    "subgroup": subgroup_batches,
    "grouping-cancellation": grouping_cancellation_batches,
}


# -- speculation poisoning ----------------------------------------------------


def speculation_poison_material(seed: int = 0) -> dict:
    """Material for the confirm-by-lookup seam: an honest full-committee
    aggregate (the memo entry), a VALID-BUT-DIFFERENT signature over the
    same message (a partial aggregate — real BLS bytes, wrong claim),
    and a stale shuffling key (a reorg that changed the committee
    permutation)."""
    rng = _rng("speculation-poisoning", seed)
    members = [_sk(rng) for _ in range(3)]
    message = _msg(rng)
    agg = members[0].sign(message).point
    for sk in members[1:]:
        agg = agg + sk.sign(message).point
    partial = members[0].sign(message).point + members[1].sign(message).point
    return {
        "message": message,
        "bits": (True,) * len(members),
        "slot": 7,
        "index": 0,
        "shuffling_key": b"shuffling-seed-epoch-n",
        "stale_shuffling_key": b"shuffling-seed-epoch-n-reorged",
        "honest_sig_bytes": Signature(agg).to_bytes(),
        "different_valid_sig_bytes": Signature(partial).to_bytes(),
    }


def _audit_speculation(seed: int) -> list[str]:
    """Drive SpeculativeVerifier.confirm with poisoned material: a
    valid-but-different signature must MISMATCH (never confirm) and a
    stale shuffling key must MISS; the honest byte-identical aggregate
    must confirm, or the probe is vacuous."""
    from ...speculate.scheduler import SpeculativeVerifier

    mat = speculation_poison_material(seed)
    sv = SpeculativeVerifier(chain=None, precompute=None)
    key = (
        bytes(mat["message"]),
        tuple(mat["bits"]),
        int(mat["slot"]),
        int(mat["index"]),
        mat["shuffling_key"],
    )
    sv._memo[key] = mat["honest_sig_bytes"]
    violations = []
    if sv.confirm(
        mat["message"], mat["bits"], mat["slot"], mat["index"],
        mat["shuffling_key"], mat["different_valid_sig_bytes"],
    ):
        violations.append(
            "speculation-poisoning: valid-but-different signature CONFIRMED "
            "by lookup"
        )
    if sv.stats["mismatches"] < 1:
        violations.append(
            "speculation-poisoning: different-signature replay was not "
            "counted as a mismatch"
        )
    if sv.confirm(
        mat["message"], mat["bits"], mat["slot"], mat["index"],
        mat["stale_shuffling_key"], mat["honest_sig_bytes"],
    ):
        violations.append(
            "speculation-poisoning: stale-shuffling aggregate CONFIRMED by "
            "lookup"
        )
    if not sv.confirm(
        mat["message"], mat["bits"], mat["slot"], mat["index"],
        mat["shuffling_key"], mat["honest_sig_bytes"],
    ):
        violations.append(
            "speculation-poisoning: the honest byte-identical aggregate "
            "failed to confirm (seam broken, probe vacuous)"
        )
    return violations


# -- the differential rejection matrix ----------------------------------------


@contextmanager
def _env(**overrides):
    saved = {}
    try:
        for k, v in overrides.items():
            saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _FailingPrimary:
    """A primary backend that dies mid-trip: the FallbackBackend records
    the fault on its breaker and re-runs the whole batch on the cpu
    oracle -- the degraded path must reject exactly like an unfaulted
    oracle run."""

    calls = 0

    def verify_signature_sets(self, sets, seed=None, device=None):
        self.calls += 1
        raise RuntimeError("injected device fault (adversary matrix)")

    def aggregate_verify(self, signature, pubkeys, messages, device=None):
        self.calls += 1
        raise RuntimeError("injected device fault (adversary matrix)")


def run_path(path: str, sets, seed: int = 0, device=None) -> bool:
    """One batch through one named verification path. The torch paths pin
    message aggregation off (per-set) or on (aggregated) for the duration
    of the call and restore the environment; they run on `device`, the
    card unless the caller asks for the CPU. `mesh_grouped` raises: the
    port has no device mesh yet (ROADMAP.md Queue 1 item 12), as the JAX
    path raises with fewer than two devices."""
    sets = list(sets)
    if path == "cpu":
        from .backends import cpu

        return bool(cpu.verify_signature_sets(sets, seed=seed))
    if path == "fallback":
        from .backends import cpu
        from .backends.fallback import FallbackBackend

        fb = FallbackBackend(primary=_FailingPrimary(), fallback=cpu)
        return bool(fb.verify_signature_sets(sets, seed=seed, device=device))
    if path == "mesh_grouped":
        raise RuntimeError(
            "mesh_grouped needs a device mesh, which the port does not have "
            "yet (ROADMAP.md Queue 1 item 12)"
        )
    from .backends import torch_cuda

    if path == "torch_per_set":
        with _env(LIGHTHOUSE_TPU_MSG_AGG="0"):
            return bool(torch_cuda.verify_signature_sets(sets, seed=seed, device=device))
    if path == "torch_aggregated":
        with _env(LIGHTHOUSE_TPU_MSG_AGG="1"):
            return bool(torch_cuda.verify_signature_sets(sets, seed=seed, device=device))
    raise ValueError(f"unknown verification path {path!r}")


def rejection_matrix(sets, seed: int = 0, paths=PATHS, device=None) -> dict:
    """Run one batch through every named path; returns {path: verdict}.
    A sound stack answers identically on all of them -- False for every
    probe batch, True for the honest controls."""
    return {path: run_path(path, sets, seed=seed, device=device)
            for path in paths}


# -- the cpu-oracle audit (scenario harness + fuzzer hook) --------------------


def audit(families, seed: int = 0, quick: bool = False) -> list[str]:
    """Run the named probe families against the cpu oracle (and the
    speculation confirm seam); returns violation strings, empty == sound.
    `quick` probes only each family's first batch (one pairing product per
    family)."""
    violations: list[str] = []
    for family in families:
        if family == "speculation-poisoning":
            violations.extend(_audit_speculation(seed))
            continue
        ctor = BATCHES.get(family)
        if ctor is None:
            violations.append(f"{family}: unknown probe family")
            continue
        batches = ctor(seed)
        if quick:
            batches = batches[:1]
        for bi, batch in enumerate(batches):
            if run_path("cpu", batch, seed=seed + bi):
                violations.append(
                    f"{family}: probe batch {bi} ACCEPTED by the cpu oracle"
                )
    return violations


# -- deliberately weakened verifiers (planted weaknesses) ---------------------
#
# Each probe family pairs with a weakness that a sound stack must not
# have; these verifiers IMPLEMENT the weakness so the suite can prove
# the probes catch it (accept the probe) while the real stack rejects
# it. They share the oracle's structural checks and pairing, so the only
# difference under test is the planted bug. Never use outside tests.


def _oracle_pairing_with_weights(sets, weights) -> bool:
    """The cpu oracle's exact grouping and pairing with CALLER-CHOSEN
    weights (the planted-weakness seam: degenerate weights are the bug
    under demonstration)."""
    from . import pairing_ref as PR
    from .backends.cpu import _set_checks

    group_pk: dict[bytes, C.Point] = {}
    order: list[bytes] = []
    sig_acc = None
    for s, r in zip(sets, weights):
        agg_pk = _set_checks(s)
        if agg_pk is None:
            return False
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


def weakened_verify_constant_weight(sets, seed=None) -> bool:
    """PLANTED WEAKNESS: every set gets the SAME weight (a broken rng, or
    weights drawn per batch-shape instead of per dispatch). The equal-
    weight collision pair cancels and verifies."""
    return _oracle_pairing_with_weights(list(sets), [1] * len(list(sets)))


def weakened_verify_zero_weight(sets, seed=None) -> bool:
    """PLANTED WEAKNESS: all-zero weights void every contribution; any
    batch (forged included) verifies vacuously."""
    return _oracle_pairing_with_weights(list(sets), [0] * len(list(sets)))


def weakened_verify_related_weights(sets, seed=None) -> bool:
    """PLANTED WEAKNESS: weights form the related ladder r_i = 2^i — the
    related-pair probe (components delta·2 and -delta on adjacent sets)
    cancels when its sets land on adjacent weights."""
    sets = list(sets)
    return _oracle_pairing_with_weights(sets, [1 << i for i in range(len(sets))])


def weakened_verify_group_then_weight(sets, seed=None) -> bool:
    """PLANTED WEAKNESS: aggregate each message group FIRST, then apply
    one random weight per GROUP — the cross-set cancellation inside a
    group survives because both forged sets share the group's weight."""
    sets = list(sets)
    rng = random.Random(seed)
    from . import pairing_ref as PR
    from .backends.cpu import _set_checks

    group_pk: dict[bytes, C.Point] = {}
    group_sig: dict[bytes, C.Point] = {}
    order: list[bytes] = []
    for s in sets:
        agg_pk = _set_checks(s)
        if agg_pk is None:
            return False
        msg = bytes(s.message)
        if msg in group_pk:
            group_pk[msg] = group_pk[msg] + agg_pk
            group_sig[msg] = group_sig[msg] + s.signature.point
        else:
            group_pk[msg] = agg_pk
            group_sig[msg] = s.signature.point
            order.append(msg)
    sig_acc = None
    pairs = []
    for m in order:
        r = rng.getrandbits(64) | 1
        pairs.append((group_pk[m].mul(r), hash_to_g2(m)))
        weighted = group_sig[m].mul(r)
        sig_acc = weighted if sig_acc is None else sig_acc + weighted
    pairs.append((-C.g1_generator(), sig_acc))
    return PR.multi_pairing(pairs) == PR.Fp12.one()
