"""One CUDA graph per stage and shape: the port of `jax.jit`'s per-shape
executable cache (and of the in-process half of
lighthouse_tpu/utils/compile_cache.py).

`graphed(fn)` wraps a stage function of tensors to a tensor or a tuple of
tensors:

  * On CPU tensors it calls `fn`: the CPU path, where every kernel wrapper
    takes its plain version.
  * On CUDA tensors of a shape not seen before (the key is every
    argument's shape, dtype and device) it runs `fn` eagerly once, which
    fills `limbs.on`'s per-device constants, builds and initialises the
    kernel libraries -- none of which a capture allows -- and gives this
    call's outputs. Then it captures `fn` into a `torch.cuda.CUDAGraph`
    over static copies of the arguments, recording every kernel launch
    that the capture took in (`kernels.recording`).
  * On CUDA tensors of a known shape it copies the arguments into the
    static inputs, replays the graph on the current stream, counts the
    capture's launches (`kernels.count_replay`) and returns clones of the
    static outputs, so a later replay never overwrites a returned tensor.

So every call runs each kernel of the stage once and counts it once. A
failed capture or replay raises; nothing re-runs eagerly in its place.

All graphs of one device share one memory pool. That is safe because
replays run one at a time (one lock for every graph), each graph's static
inputs lie outside the pool, and each static output stays referenced by
its graph and is cloned before the next replay. A graph lives as long as
its process: there is nothing to persist across processes.
"""

from __future__ import annotations

import threading
import time

import torch

from ..crypto.bls.gpu import kernels as K

_LOCK = threading.Lock()
_POOLS: dict = {}  # device -> the graph memory pool of its captures


class _Graph:
    """One captured stage at one shape: the graph, its static inputs and
    outputs, and the launch record of its capture."""

    def __init__(self, fn, args):
        dev = args[0].device
        self.inputs = tuple(a.clone() for a in args)
        pool = _POOLS.get(dev)
        if pool is None:
            pool = _POOLS[dev] = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool), K.recording() as record:
            self.outputs = fn(*self.inputs)
        self.record = tuple(record)

    def replay(self, args):
        for s, a in zip(self.inputs, args):
            s.copy_(a)
        self.graph.replay()
        K.count_replay(self.record)
        if isinstance(self.outputs, tuple):
            return tuple(t.clone() for t in self.outputs)
        return self.outputs.clone()


def shape_key(args) -> tuple:
    """The key of a graph: every argument's shape, dtype and device."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


class graphed:  # noqa: N801 -- used as a function, `graphed(fn)`
    """A stage function with its graphs, one per argument shape. `fn` is
    the plain stage; `capture_seconds` maps each key to the seconds of its
    first call (the eager run and the capture)."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}
        self.capture_seconds: dict = {}

    def __call__(self, *args):
        if not K._on_card(*args):
            return self.fn(*args)
        key = shape_key(args)
        with _LOCK:
            graph = self.graphs.get(key)
            if graph is not None:
                return graph.replay(args)
            t0 = time.perf_counter()
            out = self.fn(*args)
            self.graphs[key] = _Graph(self.fn, args)
            self.capture_seconds[key] = time.perf_counter() - t0
            return out
