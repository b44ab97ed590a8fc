"""The port's Gibbs sweep against bnpc_tpu.

* The lazy segment's plain twin (the CPU side of the CUDA kernel) against
  the Pallas kernel in interpret mode, on identical inputs: targets, sizes
  and info exactly.
* gibbs_sweep fed the JAX draws (JaxDraws) against bnpc_tpu's
  gibbs_sweep(impl="pallas", interpret=True) and impl="scan_cond":
  assignment and sizes exactly, live parameter rows to rtol 1e-6 (as
  tests/test_pallas.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnpc_tpu.data import pack_data
from bnpc_tpu.models import gibbs as jgibbs
from bnpc_tpu.ops.pallas_gibbs import pallas_lazy_segment
from bnpc_tpu.state import init_state
from bnpc_tpu_torch.models.gibbs import gibbs_sweep
from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment
from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                data_to_torch, make_problem, state_to_torch)

torch.set_num_threads(1)

N, K_PAD, K_MAX = 40, 128, 24


def _segment_inputs(case):
    rng = np.random.default_rng({"plain": 0, "birth": 1, "veto": 2}[case])
    z = (rng.standard_normal((N, K_PAD)) * 3.0).astype(np.float32)
    perm = rng.permutation(N).astype(np.int32)
    aux = np.full(N, -1e30, np.float32)
    k_max = K_MAX
    if case == "veto":
        k_max = 16  # every slot live with >= 2 cells: no slot can free up
        assign = (np.arange(N) % k_max).astype(np.int32)
        aux[perm[:3]] = 1e30
        i0 = 0
    else:
        assign = rng.integers(0, 16, N).astype(np.int32)  # slots 16.. free
        if case == "birth":
            aux[perm[25]] = 1e30
        i0 = 7
    sizes = np.bincount(assign, minlength=K_PAD).astype(np.float32)
    sizes[k_max:] = -1.0
    log_denom = np.float32(np.log(N - 1.0 + 3.0))
    return z, aux, assign, perm, sizes, i0, log_denom


@pytest.mark.parametrize("case", ["plain", "birth", "veto"])
def test_lazy_segment_twin_matches_pallas(case):
    z, aux, assign, perm, sizes, i0, log_denom = _segment_inputs(case)
    tgt_j, sizes_j, info_j = pallas_lazy_segment(
        jnp.asarray(z), jnp.asarray(aux), jnp.asarray(assign),
        jnp.asarray(perm), jnp.asarray(sizes)[None], i0, log_denom,
        interpret=True, track_veto=True)

    t = torch.from_numpy
    sizes_t = t(sizes.copy())
    tgt_t = torch.full((N,), -7, dtype=torch.int32)
    info_t = torch.zeros((4,), dtype=torch.int32)
    lazy_segment(t(z), t(aux), t(assign), t(perm), sizes_t, tgt_t, info_t,
                 i0, torch.tensor(log_denom))

    info = info_t.numpy()
    np.testing.assert_array_equal(np.asarray(info_j), info)
    np.testing.assert_array_equal(np.asarray(sizes_j)[0], sizes_t.numpy())
    i_next = int(info[0])
    np.testing.assert_array_equal(np.asarray(tgt_j)[i0:i_next],
                                  tgt_t.numpy()[i0:i_next])
    # Positions outside [i0, i_next) are left untouched.
    assert (tgt_t.numpy()[:i0] == -7).all()
    assert (tgt_t.numpy()[i_next:] == -7).all()
    expect = {"plain": (N, -1, 0), "birth": (26, int(perm[25]), 0),
              "veto": (N, -1, 1)}[case]
    assert (int(info[0]), int(info[1]), int(info[3])) == expect


@functools.lru_cache(maxsize=None)
def _jax_sweep(impl):
    return jax.jit(functools.partial(jgibbs.gibbs_sweep, impl=impl,
                                     interpret=impl == "pallas"),
                   static_argnames=("cfg",))


def _sweep_problem(seed):
    n, m = 24, 12
    data, _ = make_problem(n=n, m=m, k_clones=2, seed=seed)
    jc, tc = configs(n, m, n, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = pack_data(data)
    state = init_state(jax.random.key(seed), jc, packed, mode="random")
    return jc, tc, packed, state


@pytest.mark.parametrize("port_impl", ["lazy", "scan"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gibbs_sweep_matches_jax(seed, port_impl):
    jc, tc, packed, state = _sweep_problem(seed)
    tdata, tstate = data_to_torch(packed), state_to_torch(state)
    births = 0
    for s in range(3):
        key = jax.random.key(100 * seed + s)
        want = _jax_sweep("scan_cond")(key, state, packed, cfg=jc)
        want_pl = _jax_sweep("pallas")(key, state, packed, cfg=jc)
        got = gibbs_sweep(JaxDraws(key), tstate, tdata, tc, impl=port_impl)
        assert_states_match(want, got)
        assert_states_match(want_pl, got)
        # An empty slot that becomes occupied can only be a birth.
        births += int(((np.asarray(state.cluster_size) == 0)
                       & (np.asarray(want.cluster_size) > 0)).sum())
        state, tstate = want, state_to_torch(want)
    assert births > 0, "no cluster birth exercised"
