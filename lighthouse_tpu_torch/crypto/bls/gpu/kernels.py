"""Hand-written CUDA kernels of the verification hot path: wrappers, plain
versions and launch counts.

Seven kernels replace the seven TPU kernels of
lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py:

  fp_mul              <- pallas_kernels.fp_mul (_mul_kernel): every limbs.mul
  fp_sq               <- pallas_kernels.fp_sq (_sq_kernel): every limbs.sq
  miller_dbl_step     <- pallas_kernels.miller_dbl_step (_math_miller_dbl)
  miller_add_step     <- pallas_kernels.miller_add_step (_math_miller_add)
  fp6_mul             <- pallas_kernels.fp6_mul (_math_fp6_mul): tower.fp6_mul
  fp12_mul            <- pallas_kernels.fp12_mul (_math_fp12_mul): tower.fp12_mul
  fp12_cyclotomic_sq  <- pallas_kernels.fp12_cyclotomic_sq (_math_cyclo_sq):
                         tower.fp12_cyclotomic_sq

Sources are `lighthouse_tpu_torch/csrc/*.cu` over one device field
layer, `field_coop.cuh` (its constants and FOLD_R table in `field.cuh`),
where one warp works on one Fp element: a warp per row for fp_mul and
fp_sq, one block per row with a warp per Fp2 product for
miller_dbl_step, miller_add_step, fp6_mul, fp12_mul and
fp12_cyclotomic_sq. They are compiled with `nvcc` for sm_90a into
plain-C shared libraries at first use (`build()`), one `nvcc` per source
started together, and loaded with ctypes. The build directory is
`build/kernels/` at the repository root, keyed by a hash of the sources.

Each wrapper checks dtype and shape on any device, then takes its plain
PyTorch version only for CPU tensors; for a CUDA tensor it launches the
kernel or raises. `LAUNCHES` counts kernel launches (only there): a
launch inside a CUDA-graph capture is recorded instead, and each replay
of the graph counts its record (`count_replay`). The plain versions are
the op compositions the kernels replace, so a kernel is held bit for bit
against its plain version on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import limbs as L
from . import pairing as _PR
from . import tower as T

W = L.W

LAUNCHES = {
    "fp_mul": 0,
    "fp_sq": 0,
    "miller_dbl_step": 0,
    "miller_add_step": 0,
    "fp6_mul": 0,
    "fp12_mul": 0,
    "fp12_cyclotomic_sq": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_capture = threading.local()  # .log: the launch record of a capture


@contextlib.contextmanager
def recording():
    """Within the block, a launch on this thread goes into the yielded
    record as (kernel, rows) instead of being counted: the launches of a
    CUDA-graph capture, which run only when the graph is replayed."""
    _capture.log = []
    try:
        yield _capture.log
    finally:
        _capture.log = None


def count_replay(record) -> None:
    """Count the launches of one replay of a captured graph, from its
    capture's record (a replay makes no `_launch` call)."""
    for what, _ in record:
        LAUNCHES[what] += 1


# --- plain versions (the op compositions the kernels replace) --------------


def fp_mul_plain(a, b):
    """limbs.mul as op composition: columns + reduction."""
    return L.reduce_columns(L.mul_columns(a, b))


def fp_sq_plain(a):
    """limbs.sq: bit-identical to mul(a, a)."""
    return L.reduce_columns(L.mul_columns(a, a))


def miller_dbl_step_plain(f, t, xp, yp):
    """(mul_by_line(fp12_sq(f), line), 2T): the JAX Miller doubling body.
    tower.fp12_sq multiplies through tower.fp6_mul, so on CUDA tensors this
    composition launches the fp6_mul kernel (bit-identical to
    fp6_mul_plain) for its two Fp6 products."""
    t2, line = _PR._dbl_step(t, xp, yp)
    return _PR.mul_by_line(T.fp12_sq(f), line), t2


def miller_add_step_plain(f, t, q_aff, xp, yp):
    """(mul_by_line(f, line), T + Q): the JAX Miller addition body."""
    t2, line = _PR._add_step(t, q_aff, xp, yp)
    return _PR.mul_by_line(f, line), t2


def fp6_mul_plain(a, b):
    """tower.fp6_mul as op composition, Fp6 Karatsuba: the three diagonal
    and three cross Fp2 products as two stacked fp2_mul calls, then the
    same add/sub chains as the JAX text, stacked across c0, c1, c2."""
    a, b = torch.broadcast_tensors(a, b)
    c = T._c
    t = T.fp2_mul(a, b)  # t0, t1, t2
    t0, t1, t2 = c(t, 0), c(t, 1), c(t, 2)
    ab = torch.stack([a, b])
    s = L._fold_round(  # [a1+a2, a0+a1, a0+a2] and the same for b
        torch.stack(
            [c(ab, 1) + c(ab, 2), c(ab, 0) + c(ab, 1), c(ab, 0) + c(ab, 2)],
            dim=-3,
        )
    )
    m = T.fp2_mul(s[0], s[1])  # (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2)
    u = L.sub(m, torch.stack([t1, t0, t0], dim=-3))
    v = L.sub(u, torch.stack([t2, t1, t2], dim=-3))
    xi = T.fp2_mul_by_xi(torch.stack([c(v, 0), t2], dim=-3))
    return L.add(
        torch.stack([c(xi, 0), c(v, 1), c(v, 2)], dim=-3),
        torch.stack([t0, c(xi, 1), t1], dim=-3),
    )


def fp12_mul_plain(a, b):
    """tower.fp12_mul as op composition: Karatsuba over three Fp6 products
    (one stacked fp6_mul_plain)."""
    a, b = torch.broadcast_tensors(a, b)
    h = T._h
    a0, a1 = h(a, 0), h(a, 1)
    b0, b1 = h(b, 0), h(b, 1)
    s = L.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
    prod = fp6_mul_plain(
        torch.stack([a0, a1, s[0]], dim=-4), torch.stack([b0, b1, s[1]], dim=-4)
    )
    t0, t1, m = h(prod, 0), h(prod, 1), h(prod, 2)
    c1 = L.sub(L.sub(m, t0), t1)
    c0 = L.add(t0, T.fp6_mul_by_v(t1))
    return torch.stack([c0, c1], dim=-4)


_CYCLO_SIGN = np.array([-2, -2, -2, 2, 2, 2], np.int32)  # the 2x of 3t -+ 2x


def fp12_cyclotomic_sq_plain(a):
    """tower.fp12_cyclotomic_sq as op composition, Granger-Scott (valid
    only in the cyclotomic subgroup): 9 Fp2 squarings in ONE stacked
    fp2_sq call plus linear combines, the six 3t -+ 2x combines as one
    normalization."""
    x00, x01, x02 = a[..., 0, 0, :, :], a[..., 0, 1, :, :], a[..., 0, 2, :, :]
    x10, x11, x12 = a[..., 1, 0, :, :], a[..., 1, 1, :, :], a[..., 1, 2, :, :]
    sums = L.add(torch.stack([x11, x02, x12]), torch.stack([x00, x10, x01]))
    sq = T.fp2_sq(torch.cat([torch.stack([x11, x00, x02, x10, x12, x01]), sums]))
    t0, t1, t2, t3, t4, t5 = sq[0], sq[1], sq[2], sq[3], sq[4], sq[5]
    d = L.sub(L.sub(sq[6:9], torch.stack([t0, t2, t4])), torch.stack([t1, t3, t5]))
    t6, t7 = d[0], d[1]
    xi = T.fp2_mul_by_xi(torch.stack([d[2], t0, t2, t4]))
    t8 = xi[0]
    e = L.add(xi[1:4], torch.stack([t1, t3, t5]))
    t0, t2, t4 = e[0], e[1], e[2]
    # 3 t -+ 2 x with ONE normalization per slot (sum(|k|) = 5 <= 64)
    ts = torch.stack([t0, t2, t4, t8, t6, t7])
    xs = torch.stack([x00, x01, x02, x10, x11, x12])
    sign = L.on(_CYCLO_SIGN, a.device)
    out = L._norm(ts * 3 + xs * sign.view((6,) + (1,) * (xs.ndim - 1)))
    return torch.movedim(out.reshape((2, 3) + out.shape[1:]), (0, 1), (-4, -3))


# --- build and load --------------------------------------------------------

_PKG = Path(__file__).resolve().parents[3]  # lighthouse_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
# one shared library per source, built by concurrent nvcc processes
LIBS = {
    "fp": "fp_kernels.cu",
    "miller": "miller_kernels.cu",
    "tower": "tower_kernels.cu",
}
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict = {}
# (library, device index) pairs whose __device__ FOLD_R table is loaded
_ready: set = set()
_FOLD = torch.as_tensor(L.FOLD_R).contiguous()
BUILD_INFO: dict = {}


class KernelBuildError(RuntimeError):
    """The kernel libraries could not be built or loaded: no nvcc, an nvcc
    failure, or a library the loader refuses. A fault of the checkout or
    the toolchain, not of the device: nothing degrades around it."""


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: set CUDA_HOME or NVCC")


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(ARCH.encode())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel library that is not built yet (all nvcc
    processes started together) and load them. Returns BUILD_INFO:
    seconds, the output directory and each nvcc's -Xptxas -v report."""
    with _lock:
        if _libs:
            return BUILD_INFO
        out_dir = BUILD_ROOT / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name, src in LIBS.items():
            so = out_dir / f"lib{name}.so"
            if so.exists():
                continue
            cmd = [
                _nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-I", str(CSRC), "-o", str(so) + ".tmp", str(CSRC / src),
            ]
            # lint: allow[blocking-under-lock] -- the build runs once a
            # process: a second caller must wait until the libraries are
            # loaded, not start a second nvcc over the same .tmp output or
            # bind a library that is still being written
            procs[name] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for name, (so, proc) in procs.items():
            out, _ = proc.communicate()
            (out_dir / f"lib{name}.log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(str(so) + ".tmp", so)
        if failed:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
        for name in LIBS:
            try:
                lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            except OSError as e:
                raise KernelBuildError(f"cannot load lib{name}.so: {e}") from e
            _bind(name, lib)
            _libs[name] = lib
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0,
            dir=str(out_dir),
            built=sorted(procs),
            ptxas={
                n: (out_dir / f"lib{n}.log").read_text()
                for n in LIBS if (out_dir / f"lib{n}.log").exists()
            },
        )
        return BUILD_INFO


# C entry points of each library: name -> number of pointer arguments
# (outputs, then inputs); each also takes the row count and the stream
ENTRY = {
    "fp": {"lh_fp_mul": 3, "lh_fp_sq": 2},
    "miller": {"lh_miller_dbl": 6, "lh_miller_add": 7},
    "tower": {"lh_fp6_mul": 3, "lh_fp12_mul": 3, "lh_fp12_cyclo_sq": 2},
}


def _bind(name, lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lh_init.argtypes = [vp]
    lib.lh_init.restype = ci
    for fn, n_ptr in ENTRY[name].items():
        getattr(lib, fn).argtypes = [vp] * n_ptr + [ci, vp]
        getattr(lib, fn).restype = ci


def _lib(name: str, device: torch.device):
    """Library `name` with its FOLD_R table loaded on `device` (once per
    device: a __device__ variable belongs to one device). Call it, and
    launch, under `torch.cuda.device(device)`."""
    if not _libs:
        build()
    lib = _libs[name]
    with _lock:
        if (name, device.index) not in _ready:
            _check(lib.lh_init(_FOLD.data_ptr()), f"{name} init on {device}")
            _ready.add((name, device.index))
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} in {what}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(*ts) -> bool:
    """True when every tensor is on a CUDA device; False when every one is
    on the CPU; raises on anything else."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"kernel operands on unsupported devices {kinds}")


def _rows(t, slots: int, n: int):
    """(..., slots*W) as (n, slots*W) rows, contiguous (copies a strided or
    broadcast operand)."""
    return t.reshape(n, slots * W).contiguous()


# --- wrappers ----------------------------------------------------------------


def _operands(what: str, tail: tuple, *ts):
    """The operands broadcast together, after checking dtype int32 and the
    trailing shape `tail`; raises on a mismatch, on any device."""
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: dtype {t.dtype}, want int32")
    ts = torch.broadcast_tensors(*ts)
    if ts[0].shape[ts[0].dim() - len(tail):] != tail:
        raise ValueError(
            f"{what}: shape {tuple(ts[0].shape)}, want (..., {tail})"
        )
    return ts


def _launch(what: str, lib: str, fn: str, outs, ins, n: int) -> None:
    """Launch C entry `fn` of library `lib` on the n rows of the row-major
    tensors `outs` and `ins`, on the current stream of their device; raise
    on a nonzero cudaGetLastError(); count the launch (or, inside a
    capture, record it)."""
    if not n:
        return
    dev = outs[0].device
    with torch.cuda.device(dev):
        ptrs = [t.data_ptr() for t in (*outs, *ins)]
        _check(getattr(_lib(lib, dev), fn)(*ptrs, n, _stream(outs[0])), what)
    log = getattr(_capture, "log", None)
    if log is None:
        LAUNCHES[what] += 1
    else:
        log.append((what, n))


def fp_mul(a, b):
    """Fp product of lazy limbs, any broadcast leading shape."""
    x, y = _operands("fp_mul", (W,), a, b)
    if not _on_card(a, b):
        return fp_mul_plain(a, b)
    n = x.numel() // W
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    _launch("fp_mul", "fp", "lh_fp_mul", [out],
            [_rows(x, 1, n), _rows(y, 1, n)], n)
    return out.reshape(x.shape)


def fp_sq(a):
    """Fp square of lazy limbs, bit-identical to fp_mul(a, a)."""
    (x,) = _operands("fp_sq", (W,), a)
    if not _on_card(a):
        return fp_sq_plain(a)
    n = x.numel() // W
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    _launch("fp_sq", "fp", "lh_fp_sq", [out], [_rows(x, 1, n)], n)
    return out.reshape(x.shape)


def miller_dbl_step(f, t, xp, yp):
    """Fused Miller doubling step: f (..., 2,3,2,W), T (..., 3,2,W), P affine
    (..., W) each -> (mul_by_line(fp12_sq(f), line), 2T). Its plain
    version squares f through tower.fp6_mul, which on a CUDA tensor is the
    fp6_mul kernel (bit-identical to its own plain version)."""
    (f,) = _operands("miller_dbl_step", (2, 3, 2, W), f)
    lead = f.shape[:-4]
    (t,) = _operands("miller_dbl_step", (3, 2, W), t)
    if t.shape != lead + (3, 2, W):
        raise ValueError(f"miller_dbl_step: shapes {f.shape}, {t.shape}")
    xp, yp = _operands("miller_dbl_step", (W,), xp, yp)
    if not _on_card(f, t, xp, yp):
        return miller_dbl_step_plain(f, t, xp, yp)
    n = lead.numel()
    fo = torch.empty((n, 12 * W), dtype=torch.int32, device=f.device)
    to = torch.empty((n, 6 * W), dtype=torch.int32, device=f.device)
    ins = [_rows(f, 12, n), _rows(t, 6, n),
           _rows(xp.expand(lead + (W,)), 1, n),
           _rows(yp.expand(lead + (W,)), 1, n)]
    _launch("miller_dbl_step", "miller", "lh_miller_dbl", [fo, to], ins, n)
    return fo.reshape(f.shape), to.reshape(t.shape)


def miller_add_step(f, t, q_aff, xp, yp):
    """Fused Miller addition step: plus Q affine (..., 2,2,W) ->
    (mul_by_line(f, line), T + Q)."""
    (f,) = _operands("miller_add_step", (2, 3, 2, W), f)
    lead = f.shape[:-4]
    (t,) = _operands("miller_add_step", (3, 2, W), t)
    if t.shape != lead + (3, 2, W):
        raise ValueError(f"miller_add_step: shapes {f.shape}, {t.shape}")
    (q_aff,) = _operands("miller_add_step", (2, 2, W), q_aff)
    xp, yp = _operands("miller_add_step", (W,), xp, yp)
    if not _on_card(f, t, q_aff, xp, yp):
        return miller_add_step_plain(f, t, q_aff, xp, yp)
    n = lead.numel()
    fo = torch.empty((n, 12 * W), dtype=torch.int32, device=f.device)
    to = torch.empty((n, 6 * W), dtype=torch.int32, device=f.device)
    ins = [_rows(f, 12, n), _rows(t, 6, n),
           _rows(q_aff.expand(lead + (2, 2, W)), 4, n),
           _rows(xp.expand(lead + (W,)), 1, n),
           _rows(yp.expand(lead + (W,)), 1, n)]
    _launch("miller_add_step", "miller", "lh_miller_add", [fo, to], ins, n)
    return fo.reshape(f.shape), to.reshape(t.shape)


def fp6_mul(a, b):
    """Fp6 product, (..., 3, 2, W) each, any broadcast leading shape (the
    stacked call in tower.fp12_inv broadcasts one inverse over two rows)."""
    x, y = _operands("fp6_mul", (3, 2, W), a, b)
    if not _on_card(a, b):
        return fp6_mul_plain(a, b)
    n = x.shape[:-3].numel()
    out = torch.empty((n, 6 * W), dtype=torch.int32, device=x.device)
    _launch("fp6_mul", "tower", "lh_fp6_mul", [out],
            [_rows(x, 6, n), _rows(y, 6, n)], n)
    return out.reshape(x.shape)


def fp12_mul(a, b):
    """Fp12 product, (..., 2, 3, 2, W) each, any broadcast leading shape
    (strided halves from fp12_prod are copied to rows)."""
    x, y = _operands("fp12_mul", (2, 3, 2, W), a, b)
    if not _on_card(a, b):
        return fp12_mul_plain(a, b)
    n = x.shape[:-4].numel()
    out = torch.empty((n, 12 * W), dtype=torch.int32, device=x.device)
    _launch("fp12_mul", "tower", "lh_fp12_mul", [out],
            [_rows(x, 12, n), _rows(y, 12, n)], n)
    return out.reshape(x.shape)


def fp12_cyclotomic_sq(a):
    """Granger-Scott square of (..., 2, 3, 2, W), valid in the cyclotomic
    subgroup."""
    (x,) = _operands("fp12_cyclotomic_sq", (2, 3, 2, W), a)
    if not _on_card(a):
        return fp12_cyclotomic_sq_plain(a)
    n = x.shape[:-4].numel()
    out = torch.empty((n, 12 * W), dtype=torch.int32, device=x.device)
    _launch("fp12_cyclotomic_sq", "tower", "lh_fp12_cyclo_sq", [out],
            [_rows(x, 12, n)], n)
    return out.reshape(x.shape)