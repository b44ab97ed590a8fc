"""The error-rate MH: CUDA kernel wrapper.

The kernel (csrc/error_mh.cu, kernel 10) runs models/updates.py::
update_error_rates, two scalar truncated-normal MH steps (FP, then FN with
the new FP), in three launches around torch's sums of the likelihood terms
it writes: stage 0 writes FP's terms at its proposal and at its old value,
stage 1 decides FP and writes FN's terms at its proposal, stage 2 decides
FN, whose old likelihood is FP's chosen sum. :func:`error_mh` runs the
three launches and takes each sum as the composition does
(``ax.psum(ax.sum(terms))``), so every likelihood keeps the composition's
bits and a sharded mutation axis all-reduces it as before.

Interface: fp and fn are 0-d (one chain) or [C] (a batch); params, n1 and
n0 are [k_max, m] or [C, k_max, m]; ``ax`` the step's MutAxis or
ChainAxis. The composition's CPU scalars (the proposal's stds, the priors'
log(sd) and masses) are computed on the host by the same torch calls and
passed by value (:func:`rate`).

The draws stay torch's: :func:`primitives` draws the std index, the
proposal's uniform and the acceptance uniform of FP, then of FN, from the
providers the composition uses, in its order, so the generator's stream
moves exactly as before. It takes a TorchDraws, or a StackedDraws of them,
and raises for any other provider before any draw (a JaxDraws computes its
own truncnorm, which the kernel cannot replay).

models/updates.py routes a tensor off the CPU here (:func:`fits`) and keeps
its composition for the CPU; the kernel's plain twin is
``updates.error_rates_on`` on the primitives.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.draws import replays
from bnpc_tpu_torch.ops import _build, truncnorm
from bnpc_tpu_torch.parallel.axis import MutAxis

_NO_AXIS = MutAxis()

# Kernel launches since the last reset (each stage adds one): one-chain
# launches (0-d fp), and batched launches (fp [C], the chains' rows in one
# grid) with their count per number of chains.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}

# An error rate's proposal std multiset, in units of its prior sd
# (libs/CRP_learning_errors.py:75).
PROPOSAL_SD_FACTORS = (0.5, 1.0, 1.5)

# The stages' pointer arguments, in csrc/error_mh.cu's Args order.
POINTERS = ("params", "n1", "n0", "fp", "fn", "idx_fp", "prop_fp", "u_fp",
            "idx_fn", "prop_fn", "u_fn", "ll_new", "ll_old", "terms_new",
            "terms_old", "fp_out", "fp_acc", "ll_fp", "fn_out", "fn_acc",
            "ll_out")


class Prior(ctypes.Structure):
    """csrc/torch_ops.cuh's Prior: a rate's truncated-normal prior."""
    _fields_ = [("mean", ctypes.c_float), ("inv_sd", ctypes.c_float),
                ("log_sd", ctypes.c_float), ("mass", ctypes.c_float)]


class Rate(ctypes.Structure):
    """csrc/error_mh.cu's Rate: a rate's proposal stds and prior."""
    _fields_ = [("sd", ctypes.c_float * 3), ("prior", Prior)]


class Args(ctypes.Structure):
    """csrc/error_mh.cu's Args."""
    _fields_ = ([(name, ctypes.c_void_p) for name in POINTERS]
                + [("per_chain", ctypes.c_long), ("chains", ctypes.c_int),
                   ("rate_fp", Rate), ("rate_fn", Rate)])


def fits(device) -> bool:
    """True where the kernel runs: every device but the CPU."""
    return torch.device(device).type != "cpu"


def takes(draws) -> bool:
    """True for the providers whose truncnorm the kernel replays
    (``draws.replays``)."""
    return replays(draws, "truncnorm")


def proposal_sds(prior_sd: float) -> list[float]:
    """A rate's proposal std multiset: float32 products, as
    ``jnp.array([0.5, 1.0, 1.5]) * prior_sd``."""
    return (torch.tensor(PROPOSAL_SD_FACTORS) * prior_sd).tolist()


@functools.lru_cache(maxsize=None)
def prior(mean: float, sd: float) -> Prior:
    """The host values of distributions.truncnorm_prior_logpdf(x, mean,
    sd) on a CUDA `x`: the mean and 1 / sd as torch casts them (ATen
    divides by a CPU scalar as a product with its reciprocal), and log(sd)
    and the bounds' mass, which that function computes on the CPU."""
    f32 = torch.float32
    scale = torch.as_tensor(sd, dtype=f32)
    a = torch.tensor((0.0 - mean) / sd, dtype=f32)
    b = torch.tensor((1.0 - mean) / sd, dtype=f32)
    return Prior(torch.tensor(mean, dtype=f32).item(),
                 (torch.tensor(1.0, dtype=f32) / scale).item(),
                 torch.log(scale).item(),
                 truncnorm._log_gauss_mass(a, b).item())


@functools.lru_cache(maxsize=None)
def rate(mean: float, sd: float) -> Rate:
    """A rate's Rate from its prior mean and sd."""
    return Rate((ctypes.c_float * 3)(*proposal_sds(sd)), prior(mean, sd))


def primitives(draws, shape) -> list:
    """The six primitives of update_error_rates' composition from `draws`,
    in its order: FP's std index in [0, 3) (int32), proposal uniform and
    acceptance uniform, then FN's, each of `shape` (the rates' shape).
    Raises for a provider the kernel cannot replay (:func:`takes`), before
    any draw."""
    if not takes(draws):
        raise ValueError(f"error_mh: {type(draws).__name__} is not a "
                         "TorchDraws or a StackedDraws of them: the kernel "
                         "cannot replay its truncnorm")
    shape, out = tuple(shape), []
    for k_rate in draws.split(2):
        k_std, k_prop, k_u = k_rate.split(3)
        out += [k_std.randint(shape, 0, len(PROPOSAL_SD_FACTORS)),
                k_prop.uniform(shape), k_u.uniform(shape)]
    return out


def _launch(lib, stage, args, chains, batched, dev):
    global launches, chain_launches
    if batched:
        chain_launches += 1
        chain_grids[chains] = chain_grids.get(chains, 0) + 1
    else:
        launches += 1
    rc = lib.bnpc_error_mh(stage, ctypes.addressof(args),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, f"bnpc_error_mh stage {stage}")


def error_mh(params, n1, n0, fp, fn, prims, cfg: ModelConfig,
             ax: MutAxis = _NO_AXIS):
    """Run the three stages on drawn primitives `prims` (:func:`primitives`'
    six), each sum between them taken on `ax`. Returns (fp, fn, fp_acc,
    fn_acc, ll): the new rates, their acceptance flags and the likelihood
    at the new rates (FN's chosen sum, the step's trace ML)."""
    shape, f32, dev = tuple(fp.shape), torch.float32, params.device
    if len(shape) > 1 or tuple(params.shape[:len(shape)]) != shape \
            or params.dim() != len(shape) + 2:
        raise ValueError(f"error_mh: params {tuple(params.shape)} are not "
                         f"[k_max, m] rows of the rates {shape}")
    for name, t in (("params", params), ("n1", n1), ("n0", n0)):
        _build.check_tensor(t, name, f32, tuple(params.shape), dev)
    for name, t in (("fp", fp), ("fn", fn)):
        _build.check_tensor(t, name, f32, shape, dev)
    if len(prims) != 6:
        raise ValueError(f"error_mh: {len(prims)} primitives, expected 6")
    for r, tag in ((0, "fp"), (3, "fn")):
        _build.check_tensor(prims[r], f"idx_{tag}", torch.int32, shape, dev)
        _build.check_tensor(prims[r + 1], f"prop_{tag}", f32, shape, dev)
        _build.check_tensor(prims[r + 2], f"u_{tag}", f32, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"error_mh: unsupported device {dev}")
    lib = _build.load_library()
    chains = fp.numel()

    def new(like=fp, dtype=f32):
        return torch.empty(like.shape, dtype=dtype, device=dev)

    terms_new, terms_old = new(params), new(params)
    out = dict(fp_out=new(), fp_acc=new(dtype=torch.bool), ll_fp=new(),
               fn_out=new(), fn_acc=new(dtype=torch.bool), ll_out=new())
    tensors = dict(params=params, n1=n1, n0=n0, fp=fp, fn=fn,
                   terms_new=terms_new, terms_old=terms_old, **out,
                   **dict(zip(POINTERS[5:11], prims)))
    args = Args(**{k: t.data_ptr() for k, t in tensors.items()},
                per_chain=params.numel() // max(chains, 1), chains=chains,
                rate_fp=rate(cfg.fp, cfg.fp_sd),
                rate_fn=rate(cfg.fn, cfg.fn_sd))
    batched = len(shape) == 1

    def summed(terms):
        s = ax.psum(ax.sum(terms))
        _build.check_tensor(s, "a sum", f32, shape, dev)
        return s

    _launch(lib, 0, args, chains, batched, dev)
    ll_new, ll_old = summed(terms_new), summed(terms_old)
    fn_terms = new(params)
    args.ll_new, args.ll_old = ll_new.data_ptr(), ll_old.data_ptr()
    args.terms_new = fn_terms.data_ptr()
    _launch(lib, 1, args, chains, batched, dev)
    ll_fn = summed(fn_terms)
    args.ll_new = ll_fn.data_ptr()
    _launch(lib, 2, args, chains, batched, dev)
    return (out["fp_out"], out["fn_out"], out["fp_acc"], out["fn_acc"],
            out["ll_out"])
