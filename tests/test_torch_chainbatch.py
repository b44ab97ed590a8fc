"""The last two chain batches of the port: the blocked Gibbs sweep under
chain_exec="vmap", and a mesh rank's local chains as one batch.

* The batched blocked sweep (gibbs_sweep(impl="blocked") on a [C, ...]
  state, StackedDraws of JaxDraws) against jax.jit(jax.vmap(...)) of
  bnpc_tpu's blocked sweep on the same keys, at 24 x 12 and C = 3: one
  chain births in its first block and later ones, one only after its first
  block, one never (its alpha makes a new cluster unreachable). Assignment and sizes
  exactly, live parameter rows and scalars to rtol 1e-6.
* Whole blocked runs on the port's own draws (TorchDraws): "vmap" ==
  "sequential" chain by chain, and a run saved under one chain_exec resumed
  under the other == the uninterrupted run. The one-chain blocked sweep is
  held to bnpc_tpu's in tests/test_torch_blocked.py, so this is transitive.
* Two gloo CPU ranks (spawned from this module): a 2 x 1 mesh with 4
  chains (2 a rank) and a 1 x 2 mesh with 2 chains, exact and blocked,
  each under "vmap" == under "sequential" chain by chain; both ranks of the
  1 x 2 group count the same all-reduces after every block and hold equal
  replicated state; a blocked 1 x 2 run saved under "vmap" after 6 steps
  resumes under "sequential" to the uninterrupted run of 9. The
  sequential mesh is held to bnpc_tpu's sharded block in
  tests/test_torch_parallel.py.

Tolerances (tests/test_torch_batched.py): discrete fields exactly, floats
to rtol 1e-6 (on the CPU an elementwise op can round an ulp apart by the
element's place in its tensor; on the card the batch gives the sequential
bits, chip_smoke.py phases 11 (e) and 12 (f)).
"""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
from bnpc_tpu_torch.data import pack_data
from bnpc_tpu_torch.draws import StackedDraws
from bnpc_tpu_torch.models import gibbs as port_gibbs
from bnpc_tpu_torch.parallel.axis import ChainAxis
from bnpc_tpu_torch.state import stack_states, unstack_states

torch.set_num_threads(1)

N, M, BLOCK = 24, 12, 4
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.3, dpa_prob=0.25, error_prob=0.25, sm_steps=2)
FIELDS = ("ML", "MAP", "DP_alpha", "FN", "FP", "assignments", "params",
          "mh_counts")


def _data(seed=1):
    """tests/torch_parity.py::make_problem's matrix, without importing JAX
    (the spawned ranks import this module)."""
    rng = np.random.default_rng(seed)
    genotypes = rng.integers(0, 2, size=(3, M))
    data = genotypes[rng.integers(0, 3, size=N)].astype(float)
    data[(data == 1) & (rng.random((N, M)) < 0.1)] = 0
    data[(data == 0) & (rng.random((N, M)) < 0.01)] = 1
    data[rng.random((N, M)) < 0.1] = 3
    return data


def _runner(chain_exec, block=5, ckpt=None, mesh=None, gibbs_block=BLOCK):
    cfg = ModelConfig(n_cells=N, n_muts=M, k_max=N, **MODEL)
    return port_mcmc.MCMCRunner(
        cfg, MCMCConfig(**MIX, gibbs_block=gibbs_block),
        pack_data(_data(), "cpu"), device="cpu", block_size=block,
        checkpoint_dir=ckpt, checkpoint_every=1, mesh=mesh,
        chain_exec=chain_exec)


def _fields(res):
    return None if res is None else [
        {f: getattr(r, f) for f in FIELDS + ("burn_in",)} for r in res]


def assert_same(a, b):
    """Two runs' results chain by chain: discrete fields exactly, floats
    to rtol 1e-6."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in FIELDS:
            if f in ("assignments", "mh_counts"):
                np.testing.assert_array_equal(x[f], y[f], f)
            else:
                np.testing.assert_allclose(x[f], y[f], rtol=1e-6,
                                           err_msg=f)
        assert x["burn_in"] == y["burn_in"]


# ---------------------------------------------------------------------------
# The batched blocked sweep against bnpc_tpu's vmapped one
# ---------------------------------------------------------------------------


def test_blocked_sweep_chains_match_jax_vmap(monkeypatch):
    import jax

    from bnpc_tpu.data import pack_data as jpack
    from bnpc_tpu.models import gibbs as jgibbs
    from bnpc_tpu.state import init_state as jinit
    from tests.torch_parity import (JaxDraws, assert_states_match, configs,
                                    data_to_torch, state_to_torch)

    jc, tc = configs(N, M, N, p=0.25, q=0.25, fp=0.01, fn=0.1)
    packed = jpack(_data(2))
    # Chain 0 starts in one cluster, chain 1 cannot open a cluster (alpha
    # 1e-30: log alpha - log(n - 1) is below every Z entry), chain 2 starts
    # from a random state.
    states = [jinit(jax.random.key(s), jc, packed, mode=mode)
              for s, mode in ((0, "together"), (1, "random"),
                              (2, "random"))]
    states[1] = states[1]._replace(
        dp_alpha=jax.numpy.float32(1e-30))
    jstates = jax.tree.map(lambda *x: jax.numpy.stack(x), *states)
    keys = jax.random.split(jax.random.key(5), 3)
    sweep = jax.jit(jax.vmap(lambda k, s: jgibbs.gibbs_sweep(
        k, s, packed, jc, impl="blocked", block=BLOCK)))
    want = sweep(keys, jstates)

    born = []
    fresh = port_gibbs.fresh_row
    monkeypatch.setattr(port_gibbs, "fresh_row",
                        lambda k, cell, *a: born.append((id(k), cell)) or
                        fresh(k, cell, *a))
    tdata = data_to_torch(packed)
    tstates = [state_to_torch(st) for st in states]
    draws = [JaxDraws(k) for k in keys]
    got = port_gibbs.gibbs_sweep(StackedDraws(draws), stack_states(tstates),
                                 tdata, tc, impl="blocked", block=BLOCK,
                                 ax=ChainAxis(chains=3))
    for c, g in enumerate(unstack_states(got)):
        assert_states_match(jax.tree.map(lambda x: x[c], want), g)

    # Each chain's births by visit position (its one-chain sweep): chain 2
    # births in its first block and in two later ones, chain 0 only after
    # its first block, chain 1 never; so the batch replays blocks of
    # different chains at different positions, and leaves one alone.
    pos = {}
    perms = [JaxDraws(k).split(3)[0].permutation(N).numpy() for k in keys]
    for c, st in enumerate(tstates):
        born.clear()
        port_gibbs.gibbs_sweep(JaxDraws(keys[c]), st, tdata, tc,
                               impl="blocked", block=BLOCK)
        pos[c] = [int(np.flatnonzero(perms[c] == cell)[0])
                  for _, cell in born]
    assert pos[0] and min(pos[0]) >= BLOCK, pos
    assert not pos[1], pos
    assert min(pos[2]) < BLOCK and len({p // BLOCK for p in pos[2]}) > 2, pos


# ---------------------------------------------------------------------------
# Whole blocked runs: "vmap" == "sequential"
# ---------------------------------------------------------------------------


def test_blocked_runs_vmap_equals_sequential():
    run = dict(n_chains=3, seed=7)
    assert_same(_fields(_runner("vmap").run((12, 4), **run)),
                _fields(_runner("sequential").run((12, 4), **run)))


@pytest.mark.parametrize("first,second", [("vmap", "sequential"),
                                          ("sequential", "vmap")])
def test_blocked_resume_across_chain_exec(first, second, tmp_path):
    """10 blocked steps saved under `first`, resumed under `second` to 13
    (a partial final block) == the uninterrupted run."""
    ck = str(tmp_path / "ck")
    _runner(first, ckpt=ck).run((10, 3), seed=4, n_chains=2)
    resumed = _runner(second, ckpt=ck).run((13, 3), seed=4, n_chains=2)
    assert_same(_fields(resumed),
                _fields(_runner(first).run((13, 3), seed=4, n_chains=2)))


# ---------------------------------------------------------------------------
# A mesh rank's local chains as one batch (two gloo CPU ranks)
# ---------------------------------------------------------------------------


def _mesh_run(shape, chain_exec, n_chains, gibbs_block, steps=9, **kw):
    """One run over a `shape` mesh: (results on rank 0, the all-reduce
    count after each block, each block's replicated state bytes)."""
    from bnpc_tpu_torch.parallel import axis, sharded

    runner = _runner(chain_exec, mesh=sharded.make_mesh(*shape),
                     gibbs_block=gibbs_block, **kw)
    counts, replicated = [], []
    run_chains = runner.run_chains

    def wrapped(*args, **kwargs):
        out = run_chains(*args, **kwargs)
        counts.append(axis.all_reduces)
        replicated.append([b"".join(t.numpy().tobytes() for t in (
            st.assignment, st.cluster_size, st.dp_alpha, st.fp, st.fn))
            for st in out[0]])
        return out

    runner.run_chains = wrapped
    axis.reset_counters()
    res = runner.run((steps, 3), seed=3, n_chains=n_chains)
    assert runner.chain_exec == chain_exec
    return {"res": _fields(res), "counts": counts, "replicated": replicated}


def _rank(rank, world, port, tmp):
    from bnpc_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    out = {}
    for ex in ("vmap", "sequential"):
        out["2x1", ex] = _mesh_run((2, 1), ex, 4, 0)
        for blk in (0, BLOCK):
            out["1x2", ex, blk] = _mesh_run((1, 2), ex, 2, blk)
    ck = os.path.join(tmp, "ck")
    _mesh_run((1, 2), "vmap", 2, BLOCK, steps=6, ckpt=ck, block=3)
    out["resumed"] = _mesh_run((1, 2), "sequential", 2, BLOCK, ckpt=ck,
                               block=3)
    out["full"] = _mesh_run((1, 2), "vmap", 2, BLOCK, block=3)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_mesh_local_chains_batched(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(2, port, str(tmp_path)), nprocs=2,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    r0, r1 = ranks
    # 2 x 1: each rank batches its 2 of the 4 chains; rank 0 gathers.
    assert r1["2x1", "vmap"]["res"] is None
    assert len(r0["2x1", "vmap"]["res"]) == 4
    assert_same(r0["2x1", "vmap"]["res"], r0["2x1", "sequential"]["res"])
    for blk in (0, BLOCK):
        v, s = r0["1x2", "vmap", blk], r0["1x2", "sequential", blk]
        assert_same(v["res"], s["res"])
        for ex in ("vmap", "sequential"):
            a, b = r0["1x2", ex, blk], r1["1x2", ex, blk]
            # Both ranks of the group: the same all-reduces after every
            # block, the same replicated state.
            assert a["counts"] == b["counts"] and a["counts"][-1] > 0
            assert a["replicated"] == b["replicated"]
        # One all-reduce of the whole batch where the sequence issues one
        # a chain: never more.
        assert v["counts"][-1] <= s["counts"][-1]
    assert_same(r0["resumed"]["res"], r0["full"]["res"])
