"""The Beta posterior rows: CUDA kernel wrapper.

The kernel (csrc/beta_post.cu, kernel 8) runs state.py::
beta_posterior_params on a block of rows in one launch: for every element
a = p + n1 and b = q + n0, the two boosted Marsaglia-Tsang gammas of
ops/randomx.py::beta_general on their drawn primitives, ga / (ga + gb) (0.5
where the sum is 0) and the clamp to [TMIN, TMAX].

Interface: the counts are [..., G, m], G groups of rows (a split-merge
launch's split pair and merge row: 3) under any leading axes (a batch's
chains); row g of each leading index is drawn from the g-th provider, and
the rows come back as one [..., G, m] tensor.

The draws stay torch's: :func:`primitives` draws a row's 26 normals and
uniforms from the providers the composition uses, in its order (for each
gamma six rounds of a normal and a uniform, then the boost's uniform), so
the generator's stream moves exactly as before. It takes a TorchDraws, or a
StackedDraws of them that runs beta_general once on stacked primitives, and
raises for any other provider (a JaxDraws computes its own Beta, which the
kernel cannot replay).

state.py routes every tensor off the CPU here and keeps the composition
for the CPU; the kernel's plain twin is
``randomx.beta_general_on`` on the primitives (``state.beta_posterior_on``).
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.config import ModelConfig
from bnpc_tpu_torch.draws import StackedDraws, replays
from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.randomx import BETA_PRIMITIVES, BOOST_ROUNDS

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches, and batched launches (a StackedDraws' chains, their
# rows in one grid) with their count per number of chains.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}


def takes(draws) -> bool:
    """True for the providers whose Beta the kernel replays
    (``draws.replays``)."""
    return replays(draws, "beta_general")


def primitives(draws, shape) -> list:
    """beta_general's BETA_PRIMITIVES primitives from `draws`, each of
    `shape`, as the composition draws them (ops/randomx.py). Raises for a
    provider the kernel cannot replay (:func:`takes`), before any draw."""
    if not takes(draws):
        raise ValueError(f"beta_post: {type(draws).__name__} is not a "
                         "TorchDraws or a StackedDraws of them: the kernel "
                         "cannot replay its Beta")
    shape = tuple(shape)
    out = []
    for k_gamma in draws.split(2):
        k_boost, k = k_gamma.split(2)
        for _ in range(BOOST_ROUNDS):
            kx, ku, k = k.split(3)
            out += [kx.normal(shape), ku.uniform(shape)]
        out.append(k_boost.uniform(shape))
    return out


def beta_post(n1, n0, prims, cfg: ModelConfig, chains: int = 0):
    """Run the kernel on given primitives in one launch. `n1`, `n0` are
    [..., m] counts, a row each, `prims` their [..., 26, m] primitives;
    `chains` > 0 counts the launch as a batch of that many chains. Returns
    the [..., m] rows."""
    shape, f32, dev = tuple(n1.shape), torch.float32, n1.device
    if not shape:
        raise ValueError("beta_post: counts must have a column axis")
    _build.check_tensor(n1, "n1", f32, shape, dev)
    _build.check_tensor(n0, "n0", f32, shape, dev)
    _build.check_tensor(prims, "prims", f32,
                        shape[:-1] + (BETA_PRIMITIVES, shape[-1]), dev)
    if dev.type != "cuda":
        raise ValueError(f"beta_post: unsupported device {dev}")
    out = torch.empty(shape, dtype=f32, device=dev)
    lib = _build.load_library()
    global launches, chain_launches
    if chains:
        chain_launches += 1
        chain_grids[chains] = chain_grids.get(chains, 0) + 1
    else:
        launches += 1
    m = shape[-1]
    rc = lib.bnpc_beta_post(
        n1.data_ptr(), n0.data_ptr(), prims.data_ptr(), out.data_ptr(),
        n1.numel() // m if m else 0, m, cfg.p, cfg.q,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_beta_post")
    return out


def posterior(keys, n1, n0, cfg: ModelConfig):
    """Draw every row's primitives, group g from ``keys[g]`` in that order,
    then run the kernel on the [..., G, m] counts in one launch: what
    state.py::beta_posterior_rows computes."""
    row_shape = tuple(n1.shape[:-2]) + (n1.shape[-1],)
    prims = torch.stack([t for k in keys for t in primitives(k, row_shape)],
                        dim=-2).unflatten(-2, (len(keys), BETA_PRIMITIVES))
    chains = len(keys[0]) if isinstance(keys[0], StackedDraws) else 0
    return beta_post(n1.contiguous(), n0.contiguous(), prims, cfg, chains)
