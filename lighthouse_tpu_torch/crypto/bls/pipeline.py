"""Asynchronous BLS batch-verification pipeline: futures + double-buffering.

Port of lighthouse_tpu/crypto/bls/pipeline.py. The synchronous hot path
blocks the caller for the full device round trip of every batch. CUDA
work is already asynchronous -- the torch_cuda backend enqueues its stage
graphs on the current stream and returns a zero-dim device bool at once,
and only reading the VALUE blocks -- so the pipeline falls out of *not
asking for the answer yet*: ``submit()`` does the host-side work for a
batch (structural checks, limb packing or device-table index
marshalling, the `_field_draws_cached` hash-to-field draws), enqueues the
device work and returns a :class:`VerifyFuture`. While the card runs
batch N, the caller marshals batch N+1.

Depth is bounded (default 2: the classic double buffer): submitting past
the bound resolves the oldest in-flight batch first, so host marshalling
can never run unboundedly ahead of the device. Futures resolve strictly
in submit order -- resolving future K first resolves 0..K-1, keeping the
observable result order identical to the synchronous path.

Backends participate at two levels of the same module duck type:

  * ``dispatch_verify_signature_sets(sets, seed=None, groups=None,
    index_pack=None, pad_to=None, device=None)`` (torch_cuda): host
    marshalling + device enqueue, returning a zero-dim device bool (or a
    plain bool for structural early-exits). True async. Each keyword is
    passed only when the hook takes it: the batch's message-aggregation
    plan (``aggregation.MessageGroups``) and the gather route's
    validator-index pack are computed here, pre-marshal, on the submit
    thread; ``pad_to`` is the scheduler's warmed capacity; ``device`` is
    the submit's device, else the api's (None: the card).
  * ``verify_signature_sets`` only (cpu, fake, fallback): the pipeline
    degrades to compute-at-submit; futures still behave identically, so
    callers never branch on the backend.

A CUDA verdict is not read where it lies: ``bool()`` of a device tensor
synchronizes its whole stream, so resolving batch N would also wait for
batch N+1, queued behind it, and the double buffer would overlap
nothing. Right after the dispatch, the pipeline queues a copy of the
zero-dim verdict into pinned host memory and records a
``torch.cuda.Event`` behind it (`_stage_verdict`).
``VerifyFuture.done()`` queries that event and never blocks; resolving
waits on the event, which waits for this batch only, and reads the host
copy -- the one host sync, in ``_resolve_one``.

Every phase is recorded into an optional resilience ``EventLog`` --
("pipeline_marshal" / "pipeline_aggregate" / "pipeline_dispatch" /
"pipeline_resolve", batch=n) -- which is the test surface for the
double-buffer overlap contract: batch N+1's marshal event landing before
batch N's resolve event IS the overlap, deterministically.
"""

from __future__ import annotations

import inspect
from collections import deque

import torch

from ...obs import ledger as launch_ledger
from ...utils import metrics, tracing
from . import aggregation


class PipelineError(RuntimeError):
    pass


_PENDING = "pending"
_DISPATCHED = "dispatched"
_RESOLVED = "resolved"


class VerifyFuture:
    """Handle to one submitted batch; ``result()`` blocks (resolving any
    earlier in-flight batches first) and returns the batch verdict."""

    __slots__ = (
        "batch_id", "_pipeline", "_state", "_value", "_error", "_ctx", "_event"
    )

    def __init__(self, batch_id: int, pipeline: "VerifyPipeline"):
        self.batch_id = batch_id
        self._pipeline = pipeline
        self._state = _PENDING
        self._value = None
        self._error = None
        # span context captured at submit: resolution re-attaches it so
        # the resolve span nests under the submitting span even when a
        # different worker (or a later backpressure wait) materialises it
        self._ctx = None
        # recorded behind a CUDA verdict's host copy (`_stage_verdict`)
        self._event = None

    def done(self) -> bool:
        """True once ``result()`` would return without a device wait
        (never blocks): the verdict is resolved locally, the CUDA event
        recorded behind the verdict's host copy has completed, or the
        verdict needs no device (an eager backend, a structural verdict,
        a CPU tensor)."""
        if self._state == _RESOLVED or self._error is not None:
            return True
        if self._state != _DISPATCHED:
            return False
        if self._event is not None:
            return self._event.query()
        return True

    def result(self) -> bool:
        """The batch verdict. Blocks on the device if still in flight;
        resolves every earlier submitted batch first (submit order)."""
        if self._state != _RESOLVED:
            self._pipeline._resolve_through(self)
        if self._error is not None:
            raise self._error
        return self._value


def _stage_verdict(value):
    """(verdict, event): for a CUDA tensor verdict, a pinned host copy
    queued behind the dispatch on the current stream and an event
    recorded after the copy; any other verdict as it is, and None."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        host.copy_(value, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        return host, event
    return value, None


class VerifyPipeline:
    """Bounded-depth scheduler over the active BLS backend.

    ``backend`` may be a backend module/object or None, in which case the
    api layer's active backend is consulted at every submit (so
    ``set_backend`` keeps working mid-process). ``events`` is a
    resilience EventLog for deterministic phase-ordering assertions.
    """

    def __init__(self, backend=None, depth: int = 2, events=None):
        if depth < 1:
            raise PipelineError("pipeline depth must be >= 1")
        self._backend = backend
        self.depth = depth
        self.events = events
        self._inflight: deque[VerifyFuture] = deque()
        self._next_id = 0
        metrics.BLS_PIPELINE_DEPTH.set(depth)

    # -- introspection -------------------------------------------------------

    def occupancy(self) -> int:
        return len(self._inflight)

    def _record(self, kind: str, batch: int) -> None:
        if self.events is not None:
            self.events.record(kind, batch=batch)

    def tracer(self):
        # the PROCESS tracer, looked up per call: configure() swaps
        # apply everywhere at once
        return tracing.default_tracer()

    def _active_backend(self):
        if self._backend is not None:
            return self._backend
        from . import api

        return api._ensure_backend()

    @staticmethod
    def _device(device):
        """The submit's device, else the api's (None: the card)."""
        if device is not None:
            return device
        from . import api

        return api._DEVICE

    @staticmethod
    def _accepts(fn, name: str) -> bool:
        """True when the backend hook takes the named keyword (the
        extended duck type; older stubs keep working without it).
        Inspected per submit -- once per BATCH, not per set."""
        try:
            return name in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False

    # -- submission ----------------------------------------------------------

    def submit(
        self, sets, seed: int | None = None, pad_to: int | None = None,
        device=None,
    ) -> VerifyFuture:
        """Marshal + dispatch one batch; returns its future. Backpressure:
        at configured depth, the OLDEST in-flight batch is resolved first
        (its device work is the most likely to have finished). ``pad_to``
        asks the backend to pad the batch's set bucket to a warmed
        capacity (the continuous-batching scheduler's no-new-graph merge
        contract); backends whose dispatch hook doesn't take it -- and
        eager backends -- ignore it. ``device`` overrides the api's
        device for this batch."""
        sets = list(sets)

        def produce(fut):
            if not sets:
                # empty batch: same verdict the sync api pins (False)
                fut._value, fut._state = False, _RESOLVED
                return
            backend = self._active_backend()
            dispatch = getattr(
                backend, "dispatch_verify_signature_sets", None
            )
            if dispatch is not None:
                kwargs = {}
                if self._accepts(dispatch, "groups"):
                    # pre-marshal aggregation on the SUBMIT thread: the
                    # grouping of batch N+1 overlaps batch N's device
                    # work exactly like limb packing does
                    with tracing.span("bls_aggregate", sets=len(sets)):
                        groups = aggregation.group_sets(sets)
                    self._record("pipeline_aggregate", fut.batch_id)
                    kwargs["groups"] = groups
                    prepack = getattr(backend, "prepack_indices", None)
                    if prepack is not None and self._accepts(
                        dispatch, "index_pack"
                    ):
                        # the gather path's validator-index pack also
                        # rides the submit thread (same overlap)
                        kwargs["index_pack"] = prepack(sets)
                    if pad_to and self._accepts(dispatch, "pad_to"):
                        kwargs["pad_to"] = pad_to
                if self._accepts(dispatch, "device"):
                    kwargs["device"] = self._device(device)
                fut._value, fut._event = _stage_verdict(
                    dispatch(sets, seed=seed, **kwargs))
            else:
                # backend without async dispatch: compute at submit
                verify = backend.verify_signature_sets
                kwargs = {}
                if self._accepts(verify, "device"):
                    kwargs["device"] = self._device(device)
                fut._value = bool(verify(sets, seed=seed, **kwargs))
            fut._state = _DISPATCHED
            # one launch-ledger record per dispatched batch (runs inside
            # the pipeline_submit span, so the record cross-links to it)
            launch_ledger.record(
                "pipeline",
                real_sets=len(sets),
                padded_sets=int(pad_to) if pad_to else len(sets),
                bucket=int(pad_to) if pad_to else None,
                entries=1,
            )

        return self._enqueue(produce)

    def _enqueue(self, produce) -> VerifyFuture:
        fut = VerifyFuture(self._next_id, self)
        self._next_id += 1
        while len(self._inflight) >= self.depth:
            self._resolve_one()
        self._record("pipeline_marshal", fut.batch_id)
        tracer = self.tracer()
        with tracer.span("pipeline_submit", batch=fut.batch_id):
            fut._ctx = tracer.current()
            try:
                produce(fut)
            except Exception as e:  # noqa: BLE001 -- the future carries
                # the backend/device fault to result(), exactly where the
                # sync path would have raised it; nothing is swallowed
                fut._error, fut._state = e, _DISPATCHED
        self._record("pipeline_dispatch", fut.batch_id)
        metrics.BLS_PIPELINE_BATCHES.inc()
        if fut._state == _RESOLVED:  # structural early-exit: nothing in flight
            self._record("pipeline_resolve", fut.batch_id)
            return fut
        self._inflight.append(fut)
        occ = len(self._inflight)
        metrics.BLS_PIPELINE_OCCUPANCY.set(occ)
        if occ > metrics.BLS_PIPELINE_OCCUPANCY_PEAK.value:
            metrics.BLS_PIPELINE_OCCUPANCY_PEAK.set(occ)
        return fut

    # -- resolution ----------------------------------------------------------

    def _resolve_one(self) -> None:
        if not self._inflight:
            return
        fut = self._inflight.popleft()
        tracer = self.tracer()
        with tracer.attach(fut._ctx), tracer.span(
            "pipeline_resolve", batch=fut.batch_id
        ):
            if fut._error is None:
                # waiting on the batch's event is THE host sync point: it
                # blocks until this batch's work and verdict copy finish,
                # not the batches queued after it; then bool() reads the
                # host copy (a plain bool passes straight through)
                try:
                    if fut._event is not None:
                        fut._event.synchronize()
                    fut._value = bool(fut._value)
                except Exception as e:  # noqa: BLE001 -- a device fault
                    # can surface at materialisation rather than
                    # dispatch; the future carries it to result() either
                    # way
                    fut._error = e
        fut._state = _RESOLVED
        fut._event = None
        self._record("pipeline_resolve", fut.batch_id)
        metrics.BLS_PIPELINE_OCCUPANCY.set(len(self._inflight))

    def _resolve_through(self, fut: VerifyFuture) -> None:
        """Resolve in-flight batches oldest-first up to and including
        `fut` (futures resolve in submit order, never out of it)."""
        while fut._state != _RESOLVED:
            if not self._inflight:
                raise PipelineError(
                    f"future {fut.batch_id} is not in flight"
                )
            self._resolve_one()

    def drain(self) -> None:
        """Resolve everything in flight (shutdown/idle barrier)."""
        while self._inflight:
            self._resolve_one()


# -- module-level default (the api.verify_signature_sets_async seat) ---------

_DEFAULT: VerifyPipeline | None = None


def default_pipeline() -> VerifyPipeline:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = VerifyPipeline()
    return _DEFAULT


def configure(**kwargs) -> VerifyPipeline:
    """Replace the module-level pipeline (tests inject depth/events/
    backend here, mirroring backends/fallback.configure)."""
    global _DEFAULT
    if _DEFAULT is not None:
        _DEFAULT.drain()
    _DEFAULT = VerifyPipeline(**kwargs)
    return _DEFAULT
