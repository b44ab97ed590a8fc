"""A trace row's ML and MAP: CUDA kernel wrapper.

The kernel (csrc/trace_row.cu, kernel 11) runs mcmc.py::summarize's ML
(ops/likelihood.py::ll_from_stats on the log-prob tables) and MAP (ML plus
ops/likelihood.py::log_prior_full) in two launches around torch's sums of
the terms it writes: stage 0 writes the ML terms (unless ML is given), the
live slots' Beta terms under the column mask (unless the prior is
uniform) and the live slots' CRP size terms; stage 1 adds the log prior up
in the composition's order (the Gamma log-density of alpha first, the
error rates' priors last) and writes MAP. :func:`ml_map` takes each sum as
the composition does (``ax.sum``, and ``ax.psum`` where the composition
all-reduces), so ML and every prior term keep the composition's bits.

Interface: a state of one chain (0-d alpha, fp, fn; [k_max, m] params) or
of a batch ([C] and [C, k_max, m]); n1, n0 of params' shape; ``ax`` the
step's MutAxis or ChainAxis. The composition's CPU scalars (lgamma of the
Gamma's shape, the priors' log(sd) and masses) are computed on the host by
the same torch calls and passed by value.

mcmc.py::summarize routes a tensor off the CPU here (:func:`fits`) and keeps
the composition for the CPU, which is the kernel's plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_error_mh import Prior, prior
from bnpc_tpu_torch.parallel.axis import MutAxis

_NO_AXIS = MutAxis()

# Kernel launches since the last reset (each stage adds one): one-chain
# launches, and batched launches with their count per number of chains.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}

# The stages' pointer arguments, in csrc/trace_row.cu's Args order.
POINTERS = ("params", "n1", "n0", "sizes", "fp", "fn", "alpha", "mask",
            "ml_terms", "beta_terms", "crp_terms", "ml", "crp_sum",
            "beta_sum", "map")


class Args(ctypes.Structure):
    """csrc/trace_row.cu's Args."""
    _fields_ = ([(name, ctypes.c_void_p) for name in POINTERS]
                + [(name, ctypes.c_int) for name in ("chains", "k", "m")]
                + [(name, ctypes.c_float) for name in (
                    "pm1", "qm1", "log_beta_norm", "n_minus_1", "gamma_loc",
                    "gamma_shape_m1", "gamma_lgamma", "gamma_log_scale")]
                + [("learn_errors", ctypes.c_int), ("prior_fp", Prior),
                   ("prior_fn", Prior)])


def fits(device) -> bool:
    """True where the kernel runs: every device but the CPU."""
    return torch.device(device).type != "cpu"


@functools.lru_cache(maxsize=None)
def _constants(cfg: ModelConfig) -> dict:
    """The Args fields that depend on `cfg` alone: as torch casts each
    Python float, and the CPU values of log_prior_full's CPU tensors
    (distributions.gamma_logpdf_loc's lgamma(shape) and log(scale 1.0))."""
    f32 = torch.float32

    def cast(x):
        return torch.tensor(x, dtype=f32).item()

    return dict(
        pm1=cast(cfg.p - 1.0), qm1=cast(cfg.q - 1.0),
        log_beta_norm=cast(cfg.log_beta_norm),
        n_minus_1=cast(float(cfg.n_cells) - 1.0),
        gamma_loc=cast(cfg.dp_a_loc),
        gamma_shape_m1=cast(cfg.dp_a_shape - 1.0),
        gamma_lgamma=torch.lgamma(torch.tensor(cfg.dp_a_shape,
                                               dtype=f32)).item(),
        gamma_log_scale=torch.log(torch.tensor(1.0, dtype=f32)).item(),
        learn_errors=int(cfg.learn_errors),
        prior_fp=prior(cfg.fp, cfg.fp_sd), prior_fn=prior(cfg.fn, cfg.fn_sd))


def _launch(lib, stage, args, chains, batched, dev):
    global launches, chain_launches
    if batched:
        chain_launches += 1
        chain_grids[chains] = chain_grids.get(chains, 0) + 1
    else:
        launches += 1
    rc = lib.bnpc_trace_row(stage, ctypes.addressof(args),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, f"bnpc_trace_row stage {stage}")


def ml_map(cfg: ModelConfig, state, n1, n0, ml=None,
           ax: MutAxis = _NO_AXIS):
    """(ML, MAP) of `state` on its statistics (n1, n0), as summarize's
    composition computes them. A given `ml` is taken as ML (n1 and n0 may
    then be None): its terms and sum are left out."""
    shape, f32 = tuple(state.dp_alpha.shape), torch.float32
    params, sizes = state.params.contiguous(), state.cluster_size.contiguous()
    dev = params.device
    if len(shape) > 1 or params.dim() != len(shape) + 2 \
            or tuple(params.shape[:len(shape)]) != shape:
        raise ValueError(f"trace_row: params {tuple(params.shape)} are not "
                         f"[k_max, m] rows of the rates {shape}")
    k, m = params.shape[-2:]
    _build.check_tensor(params, "params", f32, tuple(params.shape), dev)
    _build.check_tensor(sizes, "cluster_size", torch.int32, shape + (k,), dev)
    for name, t in (("dp_alpha", state.dp_alpha), ("fp", state.fp),
                    ("fn", state.fn)):
        _build.check_tensor(t, name, f32, shape, dev)
    if ml is None:
        n1, n0 = n1.contiguous(), n0.contiguous()
        for name, t in (("n1", n1), ("n0", n0)):
            _build.check_tensor(t, name, f32, tuple(params.shape), dev)
    else:
        _build.check_tensor(ml, "ml", f32, shape, dev)
    mask = ax.mask
    if mask is not None:
        _build.check_tensor(mask, "mask", f32, (m,), dev)
    if dev.type != "cuda":
        raise ValueError(f"trace_row: unsupported device {dev}")
    lib = _build.load_library()
    chains, batched = state.dp_alpha.numel(), len(shape) == 1
    beta = not cfg.beta_prior_uniform
    ml_terms = torch.empty_like(params) if ml is None else None
    beta_terms = torch.empty_like(params) if beta else None
    crp_terms = torch.empty(sizes.shape, dtype=f32, device=dev)
    map_ = torch.empty(shape, dtype=f32, device=dev)
    tensors = dict(params=params, sizes=sizes, fp=state.fp, fn=state.fn,
                   alpha=state.dp_alpha, mask=mask, ml_terms=ml_terms,
                   beta_terms=beta_terms, crp_terms=crp_terms, map=map_)
    if ml is None:
        tensors.update(n1=n1, n0=n0)
    args = Args(**{name: None if t is None else t.data_ptr()
                   for name, t in tensors.items()},
                chains=chains, k=k, m=m, **_constants(cfg))
    _launch(lib, 0, args, chains, batched, dev)
    if ml is None:
        ml = ax.psum(ax.sum(ml_terms))
    crp_sum = ax.sum(crp_terms)
    beta_sum = ax.psum(ax.sum(beta_terms)) if beta else None
    for name, t in (("ml", ml), ("crp_sum", crp_sum), ("beta_sum", beta_sum)):
        if t is not None:
            _build.check_tensor(t, name, f32, shape, dev)
            setattr(args, name, t.data_ptr())
    _launch(lib, 1, args, chains, batched, dev)
    return ml, map_
