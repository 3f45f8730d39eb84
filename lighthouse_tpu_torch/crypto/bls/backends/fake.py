"""Always-valid stub backend (reference crypto/bls/src/impls/fake_crypto.rs):
lets state-transition and spec tests run independent of real crypto. A
copy of lighthouse_tpu/crypto/bls/backends/fake.py whose entry points
accept the port's `device=` keyword and ignore it."""

from __future__ import annotations


def verify_signature_sets(sets, seed=None, device=None) -> bool:
    return all(bool(s.pubkeys) for s in sets)


def aggregate_verify(signature, pubkeys, messages, device=None) -> bool:
    """fake_crypto: anything structurally sane (api-layer checks) passes."""
    return True
