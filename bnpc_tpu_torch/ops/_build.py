"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use,
into ``bnpc_tpu_torch/_build/`` (git-ignored); the library's file name
carries a hash of the sources, headers and flags, so an edited source
rebuilds. ``build_seconds`` holds the seconds of the last build and load
(the tracer's ``build`` span, bnpc_tpu_torch/trace.py, when it is on).

Flags: Hopper only (``sm_90a``); no ``--use_fast_math`` (the Gibbs kernel
needs the accurate ``logf`` of its plain twin); ``--fmad=false`` so that no
add is contracted into an FMA the plain torch version does not make. The
MH sweep (``csrc/mh_sweep.cu``), the Beta posterior rows
(``csrc/beta_post.cu``), a launch scan's per-cell work
(``csrc/rg_assign.cu``), the error-rate MH (``csrc/error_mh.cu``), the
trace row (``csrc/trace_row.cu``) and the split-merge acceptance
(``csrc/sm_accept.cu``) instead reproduce ATen's own CUDA
kernels, which nvcc and the jiterator build with FMA contraction on, so
they take ``--fmad=true`` (their torch-level arithmetic goes through
intrinsics that are never contracted; each file says how).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from bnpc_tpu_torch import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
]
# Sources built with FMA contraction on (module docstring).
FMAD_SOURCES = ("beta_post.cu", "error_mh.cu", "mh_sweep.cu", "rg_assign.cu",
                "sm_accept.cu", "trace_row.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: (argtypes) of every exported function; restype is int (the
# cudaGetLastError() code after the launch).
_SIGNATURES = {
    # z, aux, assign, perm, sizes, tgt, info, log_denom, bounds, full, n,
    # k_pad, i0, stream
    "bnpc_lazy_segment": [_P] * 10 + [_I, _I, _I, _P],
    # z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full,
    # chains, n, k_pad, stream
    "bnpc_lazy_segment_chains": [_P] * 11 + [_I, _I, _I, _P],
    # dz, lau, dtab, s_count, count1, out, n, stream
    "bnpc_rg_scan": [_P, _P, _P, _P, _P, _P, _I, _P],
    # dz, lau, dtab, s_count, count1, out, chains, n, stream
    "bnpc_rg_scan_chains": [_P] * 6 + [_I, _I, _P],
    # zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream
    "bnpc_lazy_stream": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad,
    # stream
    "bnpc_lazy_stream_chains": [_P] * 8 + [_I, _I, _I, _P],
    # z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom,
    # n, k_pad, m, stream
    "bnpc_eager_sweep": [_P] * 11 + [_I, _I, _I, _P],
    # z, aux, assign, perm, sizes, tgt, info, log_denom, n, k_pad, stream
    "bnpc_vecflow": [_P] * 8 + [_I, _I, _P],
    # z, perm, sizes, out, info, n, k_pad, i0, stream
    "bnpc_while_exit": [_P] * 5 + [_I, _I, _I, _P],
    # seed, out, iters, stream
    "bnpc_chain_probe": [_P, _P, _I, _P],
    # params, n1, n0, fp, fn, std_idx, u_prop, u, mask, out, declined,
    # trans, rows, rows_per_chain, m, pm1, qm1, beta_prior, trans_prob,
    # stream
    "bnpc_mh_sweep": [_P] * 12 + [_I, _I, _I, _F, _F, _I, _I, _P],
    # target, source, n1, n0, a, b, sd, fp, fn, mask, out, rows,
    # rows_per_chain, m, pm1, qm1, beta_prior, stream
    "bnpc_mh_realized": [_P] * 11 + [_I, _I, _I, _F, _F, _I, _P],
    # n1, n0, prims, out, rows, m, p, q, stream
    "bnpc_beta_post": [_P] * 4 + [_I, _I, _F, _F, _P],
    # noise, bits, ll2, s_mask, rg, anchor_i, anchor_j, n_move, dp_alpha,
    # rg_new, sides, chosen, chains, n, stream
    "bnpc_rg_assign": [_P] * 12 + [_I, _I, _P],
    # stage, args (a host Args struct), stream
    "bnpc_error_mh": [_I, _P, _P],
    "bnpc_trace_row": [_I, _P, _P],
    "bnpc_sm_accept": [_I, _P, _P],
}

_lib = None
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _flags(source: Path) -> list[str]:
    """NVCC_FLAGS for `source`, with contraction on for FMAD_SOURCES."""
    if source.name not in FMAD_SOURCES:
        return NVCC_FLAGS
    return ["--fmad=true" if f == "--fmad=false" else f for f in NVCC_FLAGS]


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(FMAD_SOURCES).encode())
    for s in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, so: Path) -> None:
    """One nvcc per source, all at once, then one link into `so`."""
    global build_log
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{s.stem}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *_flags(s), "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    if any(p.returncode for p in procs):
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    build_log += proc.stdout + proc.stderr
    shutil.rmtree(work, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{build_log}")
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter_ns()
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libbnpc_kernels_{_digest(sources)}.so"
    built = not so.exists()
    if built:
        _build(sources, so)
    lib = ctypes.CDLL(str(so))
    t1 = time.perf_counter_ns()
    build_seconds = (t1 - t0) * 1e-9
    if trace.on:
        trace.record("build", t0, t1, built=built)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — what a kernel argument must be before its pointer is
    passed."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
