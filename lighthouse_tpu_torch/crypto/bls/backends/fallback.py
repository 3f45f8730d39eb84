"""Graceful BLS backend degradation: torch_cuda primary, cpu oracle fallback.

Port of lighthouse_tpu/crypto/bls/backends/fallback.py. A device fault in
the GPU batch verifier (a CUDA error, a lost card) must never stall
signature verification -- a stalled verifier stalls the whole chain. A
kernel library that fails to build or load is no device fault: its
``KernelBuildError`` reaches the caller and nothing is re-run. ``FallbackBackend`` implements the same module
duck type the other backends expose (`verify_signature_sets` /
`aggregate_verify`) and:

  * routes to the primary while its circuit breaker is closed;
  * on any other primary failure, records the failure, surfaces the switch in
    metrics (bls_backend_fallback_total / bls_backend_using_fallback) and
    its EventLog, and re-runs the WHOLE batch on the fallback -- batch
    verification is all-or-nothing, so results are identical to an
    unfaulted fallback run;
  * re-probes the primary through the breaker's half-open budget, so a
    recovered device wins the hot path back automatically.

Selected by name only (``set_backend("fallback")``; the api's default
stays torch_cuda), or embedded directly with injected backends/breaker
for deterministic chaos tests. ``device=`` passes through to both
backends (the cpu oracle ignores it).
"""

from __future__ import annotations

from ....resilience.primitives import CircuitBreaker, EventLog
from ....utils import metrics
from ..gpu.kernels import KernelBuildError


class FallbackBackend:
    def __init__(
        self,
        primary=None,
        fallback=None,
        breaker: CircuitBreaker | None = None,
        events: EventLog | None = None,
        primary_name: str = "torch_cuda",
        fallback_name: str = "cpu",
    ):
        self._primary = primary
        self._fallback = fallback
        self.primary_name = primary_name
        self.fallback_name = fallback_name
        self.events = events
        # clock-free breaker: after `denied_budget` degraded batches the
        # primary gets one half-open probe (tests inject a clocked one)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=1,
            denied_budget=8,
            half_open_probes=1,
            name="bls_primary",
            events=events,
        )

    # backends import lazily: constructing the fallback must not build
    # kernels when only the cpu path ever runs
    def primary_backend(self):
        if self._primary is None:
            from . import torch_cuda

            self._primary = torch_cuda
        return self._primary

    def fallback_backend(self):
        if self._fallback is None:
            from . import cpu

            self._fallback = cpu
        return self._fallback

    def active_backend_name(self) -> str:
        return (
            self.primary_name
            if self.breaker.state == CircuitBreaker.CLOSED
            else self.fallback_name
        )

    def _run(self, method: str, *args, **kwargs):
        if self.breaker.allow():
            try:
                out = getattr(self.primary_backend(), method)(*args, **kwargs)
            except KernelBuildError:
                raise
            except Exception as e:  # noqa: BLE001 -- any other primary/
                # device fault degrades to the oracle; the failure is
                # recorded on the breaker and surfaced in metrics
                self.breaker.record_failure()
                metrics.BLS_FALLBACK_EVENTS.inc()
                if self.events is not None:
                    self.events.record(
                        "bls_fallback", method=method, error=type(e).__name__
                    )
            else:
                self.breaker.record_success()
                metrics.BLS_USING_FALLBACK.set(0)
                return out
        metrics.BLS_USING_FALLBACK.set(1)
        return getattr(self.fallback_backend(), method)(*args, **kwargs)

    # -- the backend duck type (api.py contract) -----------------------------

    def verify_signature_sets(self, sets, seed=None, device=None) -> bool:
        return self._run("verify_signature_sets", sets, seed=seed, device=device)

    def aggregate_verify(self, signature, pubkeys, messages, device=None) -> bool:
        return self._run(
            "aggregate_verify", signature, pubkeys, messages, device=device
        )


# -- module-level seat for api.set_backend("fallback") ------------------------

_DEFAULT: FallbackBackend | None = None


def get_default() -> FallbackBackend:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = FallbackBackend()
    return _DEFAULT


def configure(**kwargs) -> FallbackBackend:
    """Replace the module-level instance (tests inject wrapped backends
    and a clocked breaker here, then ``set_backend('fallback')``)."""
    global _DEFAULT
    _DEFAULT = FallbackBackend(**kwargs)
    return _DEFAULT


def verify_signature_sets(sets, seed=None, device=None) -> bool:
    return get_default().verify_signature_sets(sets, seed=seed, device=device)


def aggregate_verify(signature, pubkeys, messages, device=None) -> bool:
    return get_default().aggregate_verify(
        signature, pubkeys, messages, device=device
    )
