"""The port's split-merge move against bnpc_tpu.

* The restricted scan's plain twin (the CPU side of the CUDA kernel)
  against the Pallas kernel in interpret mode: sides exactly.
* split_merge fed the JAX draws (JaxDraws) against
  bnpc_tpu.models.splitmerge.split_merge(impl="pallas") with the kernel in
  interpret mode: assignment, sizes and counts exactly, live parameter rows
  to rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnpc_tpu.data import pack_data
from bnpc_tpu.models import splitmerge as jsm
from bnpc_tpu.ops import pallas_rg
from bnpc_tpu.state import init_state
from bnpc_tpu_torch.models.splitmerge import split_merge
from bnpc_tpu_torch.ops.cuda_rg import rg_scan
from tests.test_pallas_rg import interpret_kernel  # noqa: F401 (fixture)
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)


@pytest.mark.parametrize("s_count", [0, 1, 7, 40])
def test_rg_scan_twin_matches_pallas(s_count):
    n = 40
    rng = np.random.default_rng(s_count)
    dz = (rng.standard_normal(n) * 2.0).astype(np.float32)
    lau = rng.integers(0, 2, n).astype(np.int32)
    n_move = np.float32(s_count + 2)
    s1r = np.arange(n + 2, dtype=np.float32)
    with np.errstate(divide="ignore"):
        dtab = (np.log(s1r + 1.0)
                - np.log(np.maximum(n_move - s1r - 2.0, 0.0))).astype(
                    np.float32)
    count1 = int(lau[:s_count].sum())
    want = pallas_rg.rg_scan(jnp.asarray(dz), jnp.asarray(lau),
                             jnp.asarray(dtab), jnp.int32(s_count),
                             jnp.int32(count1), interpret=True)
    t = torch.from_numpy
    got = rg_scan(t(dz), t(lau), t(dtab), torch.tensor(s_count,
                                                        dtype=torch.int32),
                  torch.tensor(count1, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(want)[:s_count],
                                  got.numpy()[:s_count])


@functools.lru_cache(maxsize=None)
def _jax_split_merge():
    # One compile for every case: the split ratio is traced.
    return jax.jit(functools.partial(jsm.split_merge, sm_steps=3,
                                     impl="pallas"),
                   static_argnames=("cfg",))


def _problem(seed, start):
    """A state to propose from. "random" is a random partition;
    "together" puts every cell in one cluster (a split should win);
    "oversplit" spreads one clone over two slots (a merge should win)."""
    n, m = 24, 16
    data, _ = make_problem(n=n, m=m, k_clones=1 if start == "oversplit"
                           else 2, seed=seed)
    jc, tc = configs(n, m, n, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = pack_data(data)
    key = jax.random.key(seed)
    if start == "random":
        state = init_state(key, jc, packed, mode="random")
    elif start == "together":
        state = init_state(key, jc, packed, mode="together")
    else:
        state = init_state(key, jc, packed, assign=np.arange(n) % 2)
    return jc, tc, packed, state


@pytest.mark.parametrize("start,ratio", [("random", 0.75),
                                         ("random", 0.0),
                                         ("together", 1.0),
                                         ("oversplit", 0.0)])
@pytest.mark.parametrize("seed", [1, 2])
def test_split_merge_matches_jax(seed, start, ratio, interpret_kernel):
    jc, tc, packed, state = _problem(seed, start)
    tdata = data_to_torch(packed)
    accepted = 0
    for s in range(5):
        key = jax.random.key(1000 * seed + s)
        want, want_counts = _jax_split_merge()(
            key, state, packed, cfg=jc, sm_split_ratio=jnp.float32(ratio))
        got, got_counts = split_merge(JaxDraws(key), state_to_torch(state),
                                      tdata, tc, ratio, 3)
        assert_states_match(want, got)
        np.testing.assert_array_equal(np.asarray(want_counts),
                                      got_counts.numpy())
        accepted += int(np.asarray(want_counts)[:, 0].sum())
        state = want
    if start != "random":
        assert accepted > 0, "no accepted move exercised"
