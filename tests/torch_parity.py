"""Parity helpers for the port's tests: a draw provider that replays JAX.

``JaxDraws`` wraps a JAX key and implements the port's Draws interface by
calling ``jax.random`` and the bnpc_tpu samplers on that key, returning the
JAX package's own draws as CPU tensors. A port function fed ``JaxDraws(key)``
therefore consumes exactly the randomness its bnpc_tpu counterpart consumes
on ``key``. Test-only: it imports jax.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bnpc_tpu.models import gibbs as jgibbs
from bnpc_tpu.ops import randomx as jrandomx
from bnpc_tpu.ops import truncnorm as jtruncnorm
from bnpc_tpu_torch.draws import Draws

# Jitted, as inside the bnpc_tpu step programs: XLA:CPU contracts
# multiply-adds into FMAs within a fusion, which eager op-by-op dispatch
# does not, and the samplers' tails amplify that last-ulp difference.
_beta_binary = jax.jit(jrandomx.beta_binary, static_argnums=(1, 2))
_beta_general = jax.jit(jrandomx.beta_general)
_truncnorm = jax.jit(jtruncnorm.rvs)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _fresh_rows(key, p, q, xm, xm0):
    """bnpc_tpu's per-cell newborn rows (models/gibbs.py::fresh_row), one
    per cell from fold_in(key, cell), as _hoisted_randomness draws them."""
    data = types.SimpleNamespace(xm=xm, xm0=xm0)
    cfg = types.SimpleNamespace(p=p, q=q)
    return jax.vmap(lambda c: jgibbs.fresh_row(key, c, data, cfg))(
        jnp.arange(xm.shape[0]))


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def to_jax(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return jnp.asarray(x)


class JaxDraws(Draws):
    device = torch.device("cpu")

    def __init__(self, key):
        self.key = key

    def split(self, n: int) -> list["Draws"]:
        return [JaxDraws(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i: int) -> "Draws":
        return JaxDraws(jax.random.fold_in(self.key, int(i)))

    def fold_axis(self, i: int) -> "Draws":
        # bnpc_tpu's MutAxis.fold_key: fold_in(key, axis_index).
        return self.fold_in(i)

    def uniform(self, shape):
        return to_torch(jax.random.uniform(self.key, tuple(shape)))

    def normal(self, shape):
        return to_torch(jax.random.normal(self.key, tuple(shape)))

    def gumbel(self, shape):
        return to_torch(jax.random.gumbel(self.key, tuple(shape)))

    def bits(self, shape):
        return to_torch(jax.random.bits(self.key, tuple(shape),
                                        dtype=jnp.uint32))

    def randint(self, shape, lo, hi):
        return to_torch(jax.random.randint(self.key, tuple(shape), lo, hi,
                                           dtype=jnp.int32))

    def categorical(self, logits):
        return to_torch(jax.random.categorical(self.key, to_jax(logits))
                        .astype(jnp.int32))

    def permutation(self, n):
        return to_torch(jax.random.permutation(self.key, n)
                        .astype(jnp.int32))

    def beta(self, a, b):
        return to_torch(jax.random.beta(self.key, to_jax(a), b))

    def gamma(self, a):
        return to_torch(jax.random.gamma(self.key, to_jax(a)))

    def beta_binary(self, p, q, xm, xm0):
        return to_torch(_beta_binary(self.key, p, q, to_jax(xm),
                                     to_jax(xm0)))

    def fresh_rows(self, p, q, xm, xm0):
        return to_torch(_fresh_rows(self.key, p, q, to_jax(xm), to_jax(xm0)))

    def beta_general(self, a, b):
        return to_torch(_beta_general(self.key, to_jax(a), to_jax(b)))

    def truncnorm(self, a, b, loc, scale):
        return to_torch(_truncnorm(self.key, to_jax(a), to_jax(b),
                                   to_jax(loc), to_jax(scale)))


def make_problem(n=30, m=16, k_clones=3, seed=0, missing=0.1):
    """Simulated clone-structured noisy binary matrix (tests/test_moves.py)."""
    rng = np.random.default_rng(seed)
    genotypes = rng.integers(0, 2, size=(k_clones, m))
    true_assign = rng.integers(0, k_clones, size=n)
    data = genotypes[true_assign].astype(float)
    data[(data == 1) & (rng.random((n, m)) < 0.1)] = 0
    data[(data == 0) & (rng.random((n, m)) < 0.01)] = 1
    data[rng.random((n, m)) < missing] = np.nan
    return data, true_assign


def state_to_torch(state):
    """A bnpc_tpu CRPState as the port's CRPState on the CPU."""
    from bnpc_tpu_torch.convert import state_from_numpy

    return state_from_numpy(*(np.asarray(x) for x in state), device="cpu")


def data_to_torch(packed):
    from bnpc_tpu_torch.convert import data_from_numpy

    return data_from_numpy(*(np.asarray(x) for x in packed), device="cpu")


def configs(n, m, k_max, **kw):
    """The same model configuration in both packages."""
    from bnpc_tpu.config import ModelConfig as JCfg
    from bnpc_tpu_torch.config import ModelConfig as TCfg

    return (JCfg(n_cells=n, n_muts=m, k_max=k_max, **kw),
            TCfg(n_cells=n, n_muts=m, k_max=k_max, **kw))


def assert_states_match(jstate, tstate, rtol=1e-6):
    """Assignment and sizes exactly; live parameter rows and scalars to
    rtol."""
    np.testing.assert_array_equal(np.asarray(jstate.assignment),
                                  tstate.assignment.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.cluster_size),
                                  tstate.cluster_size.numpy())
    live = np.asarray(jstate.cluster_size) > 0
    np.testing.assert_allclose(np.asarray(jstate.params)[live],
                               tstate.params.numpy()[live], rtol=rtol)
    for f in ("dp_alpha", "fp", "fn"):
        np.testing.assert_allclose(np.asarray(getattr(jstate, f)),
                                   getattr(tstate, f).numpy(), rtol=rtol)
