"""The port's batched chains (MCMCRunner chain_exec="vmap") against
bnpc_tpu and against the port's own sequential chains.

* Whole runs on an injected root provider (JaxDraws) against bnpc_tpu's
  MCMCRunner(chain_exec="vmap") and its coupled vmap pipe: assignments and
  MH counts exactly; ML, alpha, FP / FN and the params trace (recorded
  in float32 here) to rtol 1e-6; the log prior (MAP - ML; ROADMAP queue 3
  says why not MAP) to rtol 3e-6: the port's one-chain run differs from
  bnpc_tpu's there by up to 1.15e-6 relative on these draws, the batched
  run by the same (XLA and torch order a sum of a few hundred terms
  differently, and the terms cancel; ML differs by 2.0e-7). The chains take
  different moves in some step.
* The port's own draws (TorchDraws): "vmap" == "sequential", coupled too,
  and a run saved under one chain_exec resumed under the other equals the
  uninterrupted run. Discrete outputs exactly, floats to rtol 1e-6: on the
  CPU an elementwise op takes its scalar tail or its vector body by the
  element's place in the tensor, and the two can round a transcendental
  an ulp apart (on the card the batch gives the sequential bits;
  chip_smoke.py phase 12).
* The batched Gibbs sweep (lazy and stream, on the kernels' twins) and the
  batched split-merge (chains that split beside chains that merge) against
  the one-chain move, chain by chain.
* The batched twins of kernels 1, 3 and 2 against the Pallas kernels in
  interpret mode, chain by chain, on ragged crafted batches.
* StackedDraws slice c == chain c's provider; the refusals (eager) and
  "auto"'s rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bnpc_tpu.ops.pallas_gibbs as pg
from bnpc_tpu import mcmc as jax_mcmc
from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data
from bnpc_tpu.ops import pallas_rg
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig
from bnpc_tpu_torch.data import pack_data as port_pack
from bnpc_tpu_torch.draws import StackedDraws, TorchDraws
from bnpc_tpu_torch.models.gibbs import gibbs_sweep
from bnpc_tpu_torch.models.splitmerge import split_merge
from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment_chains
from bnpc_tpu_torch.ops.cuda_rg import rg_scan_chains
from bnpc_tpu_torch.ops.cuda_stream import lazy_segment_stream_chains
from bnpc_tpu_torch.parallel.axis import ChainAxis
from bnpc_tpu_torch.state import init_state, stack_states, unstack_states
from tests.torch_parity import JaxDraws, configs, make_problem

torch.set_num_threads(1)

N, M, BLOCK = 24, 12, 10
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.3, dpa_prob=0.25, error_prob=0.25, sm_steps=2)
DATA, _ = make_problem(n=N, m=M, k_clones=3, seed=1)
JCFG, TCFG = configs(N, M, N, **MODEL)
RESULT_FIELDS = ("ML", "MAP", "DP_alpha", "FN", "FP", "assignments",
                 "params", "mh_counts")


def _port(block=BLOCK, ckpt=None, chain_exec="vmap", **mix):
    return port_mcmc.MCMCRunner(TCFG, MCMCConfig(**{**MIX, **mix}),
                                port_pack(DATA, "cpu"), device="cpu",
                                block_size=block, checkpoint_dir=ckpt,
                                checkpoint_every=1, chain_exec=chain_exec)


def assert_matches_jax(jres, pres):
    assert len(jres) == len(pres)
    for j, p in zip(jres, pres):
        np.testing.assert_array_equal(j.assignments, p.assignments)
        np.testing.assert_array_equal(j.mh_counts, p.mh_counts)
        assert j.burn_in == p.burn_in
        np.testing.assert_allclose(p.MAP - p.ML, j.MAP - j.ML, rtol=3e-6)
        for f in ("ML", "DP_alpha", "FP", "FN"):
            np.testing.assert_allclose(getattr(p, f), getattr(j, f),
                                       rtol=1e-6)
        w = j.params.shape[1]
        np.testing.assert_allclose(p.params[:, :w], j.params, rtol=1e-6)
        assert not p.params[:, w:].any()


def assert_same(a, b):
    """Two port results: discrete fields exactly, floats to rtol 1e-6."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in RESULT_FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            if f in ("assignments", "mh_counts"):
                np.testing.assert_array_equal(u, v, f)
            else:
                np.testing.assert_allclose(u, v, rtol=1e-6, err_msg=f)
        assert x.burn_in == y.burn_in


def assert_states_close(got, want):
    """Two one-chain states: assignment and sizes exactly, floats to rtol
    1e-6."""
    torch.testing.assert_close(got.assignment, want.assignment, rtol=0,
                               atol=0)
    torch.testing.assert_close(got.cluster_size, want.cluster_size, rtol=0,
                               atol=0)
    for f in ("params", "dp_alpha", "fp", "fn"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Against bnpc_tpu
# ---------------------------------------------------------------------------


def test_vmap_matches_jax(monkeypatch):
    """3 chains, 16 steps in blocks of 10 (the last one partial), against
    bnpc_tpu's vmapped pipe; the chains' move kinds differ in some step."""
    monkeypatch.setenv("BNPC_TPU_TRACE_F32", "1")
    kinds = []
    append = port_mcmc._TraceBuffer.append

    def record(self, rows):
        kinds.append(rows["mh_counts"][:, :, 1:3].sum(axis=(2, 3)) > 0)
        append(self, rows)

    monkeypatch.setattr(port_mcmc._TraceBuffer, "append", record)
    jr = jax_mcmc.MCMCRunner(JCFG, JMCMCConfig(**MIX), pack_data(DATA),
                             block_size=BLOCK, chain_exec="vmap")
    want = jr.run((16, 4), seed=3, n_chains=3, verbosity=0)
    runner = _port()
    got = runner.run((16, 4), n_chains=3, draws=JaxDraws(jax.random.key(3)))
    assert runner.chain_exec == "vmap"
    assert_matches_jax(want, got)
    sm = np.concatenate(kinds, axis=1)  # [chains, steps]: split-merge taken
    assert (sm.any(axis=0) & ~sm.all(axis=0)).any()


def test_coupled_vmap_matches_jax(monkeypatch):
    monkeypatch.setenv("BNPC_TPU_TRACE_F32", "1")
    jr = jax_mcmc.MCMCRunner(JCFG, dataclasses.replace(
        JMCMCConfig(**MIX), coupled_moves=True), pack_data(DATA),
        block_size=BLOCK, chain_exec="vmap")
    want = jr.run((16, 4), seed=5, n_chains=2, verbosity=0)
    got = _port(coupled_moves=True).run((16, 4), n_chains=2,
                                        draws=JaxDraws(jax.random.key(5)))
    assert_matches_jax(want, got)


# ---------------------------------------------------------------------------
# The port's own draws: batched == sequential
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coupled", [False, True])
def test_vmap_equals_sequential(coupled):
    run = dict(n_chains=3, seed=7)
    assert_same(_port(coupled_moves=coupled).run((16, 4), **run),
                _port(coupled_moves=coupled,
                      chain_exec="sequential").run((16, 4), **run))


@pytest.mark.parametrize("first,second", [("vmap", "sequential"),
                                          ("sequential", "vmap")])
def test_resume_across_chain_exec(first, second, tmp_path):
    """10 steps saved under `first`, resumed under `second` to 17 (a partial
    final block) == the uninterrupted run under either."""
    ck = str(tmp_path / "ck")
    _port(block=5, ckpt=ck, chain_exec=first).run((10, 3), seed=4,
                                                  n_chains=3)
    resumed = _port(block=5, ckpt=ck, chain_exec=second).run(
        (17, 3), seed=4, n_chains=3)
    assert_same(resumed, _port(block=5, chain_exec=first).run(
        (17, 3), seed=4, n_chains=3))


@pytest.mark.parametrize("chain_exec", ["sequential", "vmap"])
def test_coupled_torchdraws_layout(chain_exec):
    """The coupled step on TorchDraws, one stream a chain: the shared move
    choice is drawn from chain 0's stream, and chain c's move, alpha,
    parameter and error draws are split(5)[1:] of its OWN step draws, under
    either chain_exec."""
    seeds, steps = (31, 32, 33), 6
    cfg, data, states = _states(seeds)
    runner = _port(coupled_moves=True, chain_exec=chain_exec)
    got, rows, _ = runner.run_chains(
        list(states), [TorchDraws(100 + s, "cpu") for s in seeds], steps)
    select, moves = port_mcmc._make_moves(cfg, runner.mcmc_cfg, data,
                                          runner.trace_k, "auto", 0)
    keys = [TorchDraws(100 + s, "cpu").split(steps + 1) for s in seeds]
    want, sm = list(states), []
    for t in range(1, steps + 1):
        flags, _ = select(keys[0][t].split(5)[0])
        sm.append(flags[0][0])
        want = [moves(st, flags, None, *k[t].split(5)[1:])[0]
                for st, k in zip(want, keys)]
    for g, w in zip(got, want):
        assert_states_close(g, w)
    assert any(sm) and not all(sm)


def _states(seeds, mode="random"):
    data = port_pack(DATA, "cpu")
    return TCFG, data, [init_state(TorchDraws(s, "cpu"), TCFG, data, "cpu",
                                   mode=mode) for s in seeds]


@pytest.mark.parametrize("impl", ["lazy", "stream", "scan"])
def test_gibbs_sweep_chains(impl):
    """The batched sweep == each chain's one-chain sweep on its own
    stream, with births (every chain starts in one cluster)."""
    seeds = (11, 12, 13)
    cfg, data, states = _states(seeds, mode="together")
    want = [gibbs_sweep(TorchDraws(100 + s, "cpu"), st, data, cfg, impl=impl)
            for s, st in zip(seeds, states)]
    got = gibbs_sweep(StackedDraws([TorchDraws(100 + s, "cpu")
                                    for s in seeds]),
                      stack_states(states), data, cfg, impl=impl,
                      ax=ChainAxis(chains=3))
    for w, g in zip(want, unstack_states(got)):
        assert_states_close(g, w)
    births = [int(((w.cluster_size > 0) & (s.cluster_size == 0)).sum())
              for w, s in zip(want, states)]
    assert min(births) > 0 and len(set(births)) > 1


def test_split_merge_chains():
    """Batched split-merge == each chain's one-chain move, over proposals
    where some chains split while others merge."""
    seeds = (21, 22, 23, 24)
    cfg, data, states = _states(seeds)
    mixed = 0
    for step in range(6):
        keys = [TorchDraws(1000 * step + s, "cpu") for s in seeds]
        want = [split_merge(k, st, data, cfg, 0.5, 2)
                for k, st in zip(keys, states)]
        keys = [TorchDraws(1000 * step + s, "cpu") for s in seeds]
        got, counts = split_merge(StackedDraws(keys), stack_states(states),
                                  data, cfg, 0.5, 2, ax=ChainAxis(chains=4))
        for (w, wc), g, gc in zip(want, unstack_states(got), counts):
            assert_states_close(g, w)
            torch.testing.assert_close(gc, wc, rtol=0, atol=0)
        split = [int(wc[0].sum()) for _, wc in want]
        mixed += 0 < sum(split) < len(split)
        states = [w for w, _ in want]
    assert mixed > 0


# ---------------------------------------------------------------------------
# The batched kernels' twins against the Pallas kernels
# ---------------------------------------------------------------------------

KN, K_PAD, K_MAX = 40, 128, 24
# (case, i0, hot position): a birth at i0, a birth at n - 1, no birth, a
# chain already done, a birth mid-segment.
CHAINS = (("birth_at_i0", 5, 5), ("birth_last", 0, KN - 1),
          ("no_birth", 3, None), ("done", KN, None), ("birth_mid", 11, 30))


def _batch(stream):
    z, aux, assign, perm, sizes, i0 = [], [], [], [], [], []
    for c, (_, start, hot) in enumerate(CHAINS):
        rng = np.random.default_rng(c)
        z.append((rng.standard_normal((KN, K_PAD)) * 3.0).astype(np.float32))
        p = np.arange(KN) if stream else rng.permutation(KN)
        perm.append(p.astype(np.int32))
        a = np.full(KN, -1e30, np.float32)
        if hot is not None:
            a[p[hot]] = 1e30
        aux.append(a)
        assign.append(rng.integers(0, 16, KN).astype(np.int32))
        s = np.bincount(assign[-1], minlength=K_PAD).astype(np.float32)
        s[K_MAX:] = -1.0
        sizes.append(s)
        i0.append(start)
    log_denom = np.log(KN - 1.0 + np.arange(2.0, 7.0)).astype(np.float32)
    return (*(np.stack(x) for x in (z, aux, assign, perm, sizes)),
            np.asarray(i0, np.int32), log_denom)


@pytest.mark.parametrize("stream", [False, True])
def test_segment_chains_twin_matches_pallas(stream):
    z, aux, assign, perm, sizes, i0, log_denom = _batch(stream)
    t = torch.from_numpy
    c_all = len(CHAINS)
    sizes_t = t(sizes.copy())
    tgt_t = torch.full((c_all, KN), -7, dtype=torch.int32)
    info_t = torch.zeros((c_all, 4), dtype=torch.int32)
    i0s = t(i0.copy())
    if stream:
        lazy_segment_stream_chains(t(z), t(aux), t(assign), sizes_t, tgt_t,
                                   info_t, i0s, t(log_denom))
    else:
        lazy_segment_chains(t(z), t(aux), t(assign), t(perm), sizes_t,
                            tgt_t, info_t, i0s, t(log_denom))
    np.testing.assert_array_equal(i0s.numpy(), info_t[:, 0].numpy())
    for c, (case, start, hot) in enumerate(CHAINS):
        info = info_t[c].numpy()
        if case == "done":
            assert info.tolist() == [KN, -1, -1, 0]
            np.testing.assert_array_equal(sizes_t[c].numpy(), sizes[c])
            assert (tgt_t[c].numpy() == -7).all()
            continue
        if stream:
            tgt_j, sizes_j, info_j = pg.pallas_lazy_segment_stream(
                jnp.asarray(z[c]).reshape(KN // 8, 8, K_PAD),
                jnp.asarray(aux[c]), jnp.asarray(assign[c]),
                jnp.asarray(sizes[c])[None], start, log_denom[c],
                interpret=True, track_veto=True)
        else:
            tgt_j, sizes_j, info_j = pg.pallas_lazy_segment(
                jnp.asarray(z[c]), jnp.asarray(aux[c]),
                jnp.asarray(assign[c]), jnp.asarray(perm[c]),
                jnp.asarray(sizes[c])[None], start, log_denom[c],
                interpret=True, track_veto=True)
        np.testing.assert_array_equal(np.asarray(info_j), info)
        np.testing.assert_array_equal(np.asarray(sizes_j)[0],
                                      sizes_t[c].numpy())
        np.testing.assert_array_equal(np.asarray(tgt_j)[start:info[0]],
                                      tgt_t[c].numpy()[start:info[0]])
        birth = -1 if hot is None else (hot if stream else int(perm[c][hot]))
        assert int(info[1]) == birth
        assert int(info[0]) == (KN if hot is None else hot + 1)


def test_rg_scan_chains_twin_matches_pallas():
    """s_count 0, 1, ragged (7, 23) and n in one batch."""
    counts = (0, 1, 7, 23, KN)
    dz, lau, dtab, count1 = [], [], [], []
    for c, s_count in enumerate(counts):
        rng = np.random.default_rng(50 + c)
        dz.append((rng.standard_normal(KN) * 2.0).astype(np.float32))
        lau.append(rng.integers(0, 2, KN).astype(np.int32))
        s1r = np.arange(KN + 2, dtype=np.float32)
        with np.errstate(divide="ignore"):
            dtab.append((np.log(s1r + 1.0) - np.log(np.maximum(
                np.float32(s_count + 2) - s1r - 2.0, 0.0))).astype(
                    np.float32))
        count1.append(int(lau[-1][:s_count].sum()))
    t = torch.from_numpy
    got = rg_scan_chains(t(np.stack(dz)), t(np.stack(lau)),
                         t(np.stack(dtab)),
                         torch.tensor(counts, dtype=torch.int32),
                         torch.tensor(count1, dtype=torch.int32))
    for c, s_count in enumerate(counts):
        want = pallas_rg.rg_scan(jnp.asarray(dz[c]), jnp.asarray(lau[c]),
                                 jnp.asarray(dtab[c]), jnp.int32(s_count),
                                 jnp.int32(count1[c]), interpret=True)
        np.testing.assert_array_equal(np.asarray(want)[:s_count],
                                      got[c].numpy()[:s_count])


# ---------------------------------------------------------------------------
# StackedDraws, refusals, "auto"
# ---------------------------------------------------------------------------


def _draw_all(d, lead):
    """One of each draw of the Draws interface; `lead` the chain axis."""
    logits = torch.log(torch.arange(1.0, 7.0)).expand(lead + (6,))
    a = torch.full(lead + (5,), 1.5)
    b = torch.full(lead + (5,), 0.5)
    xm = (torch.arange(10.0).expand(lead + (10,)) % 3 == 0).float()
    k1, k2 = d.split(2)
    return [d.uniform(lead + (4,)), d.normal(lead + (2, 3)),
            d.gumbel(lead + (5,)), d.bits(lead + (2, 3)),
            d.randint(lead + (7,), 0, 9), d.categorical(logits),
            d.permutation(9), d.gamma(a), d.beta(a, 2.0),
            k1.beta_binary(0.25, 0.25, xm, 1.0 - xm),
            k2.fold_in(3).beta_general(a, b),
            d.truncnorm(-a, b, 0.5 * b, b)]


@pytest.mark.parametrize("provider", ["torch", "torch_batched", "jax"])
def test_stacked_draws_slice_is_the_chain(provider, monkeypatch):
    """Slice c == chain c's draws: exactly where a composite runs per chain
    (the CPU, JaxDraws); "torch_batched" runs TorchDraws' composites once on
    the stacked primitives, the route of a CUDA batch, on the CPU: integer
    draws exactly, floats to rtol 1e-5 (module docstring: the CPU's
    vector body and scalar tail round apart; the samplers amplify it)."""
    def make(c):
        return (JaxDraws(jax.random.key(30 + c)) if provider == "jax"
                else TorchDraws(30 + c, "cpu"))

    exact = provider != "torch_batched"
    if not exact:
        monkeypatch.setattr(StackedDraws, "_batched",
                            lambda self, name: True)
    got = _draw_all(StackedDraws([make(c) for c in range(3)]), (3,))
    for c in range(3):
        for g, w in zip(got, _draw_all(make(c), ())):
            if exact or not w.is_floating_point():
                torch.testing.assert_close(g[c], w, rtol=0, atol=0)
            else:
                torch.testing.assert_close(g[c], w, rtol=1e-5, atol=1e-7)


def test_refusals():
    """The eager sweep has no batched form: refused by the batched sweep
    and by a batched mesh block; the blocked sweep and a mesh run batched
    (tests/test_torch_chainbatch.py)."""
    from bnpc_tpu_torch.parallel import sharded

    assert _port(gibbs_block=8).chain_exec == "vmap"
    with pytest.raises(ValueError, match="eager"):
        port_mcmc._check_chains_step("eager")
    port_mcmc._check_chains_step("blocked")
    mesh = sharded.Mesh(1, 1, 0, None, None)
    with pytest.raises(ValueError, match="eager"):
        sharded.make_sharded_block(mesh, TCFG, MCMCConfig(**MIX),
                                   port_pack(DATA, "cpu"),
                                   gibbs_impl="eager", chain_exec="vmap")
    assert sharded.make_sharded_block(
        mesh, TCFG, MCMCConfig(**MIX, gibbs_block=8), port_pack(DATA, "cpu"),
        chain_exec="vmap").chain_exec == "vmap"
    cfg, data, states = _states((1, 2))
    with pytest.raises(ValueError, match="eager"):
        gibbs_sweep(StackedDraws([TorchDraws(1, "cpu")] * 2),
                    stack_states(states), data, cfg, impl="eager",
                    ax=ChainAxis(chains=2))
    with pytest.raises(ValueError, match="chain_exec"):
        _port(chain_exec="pmap")


# resolve_chain_exec's answers for uncoupled chains: (chain_exec, device)
# -> the answer without a mesh (gibbs_block 0, 8), then under one (0, 8).
AUTO_EXACT = {
    ("auto", "cpu"): ("sequential", "sequential", "sequential", "sequential"),
    ("auto", "cuda"): ("sequential", "sequential", "sequential",
                       "sequential"),
    ("sequential", "cpu"): ("sequential", "sequential", "sequential",
                            "sequential"),
    ("sequential", "cuda"): ("sequential", "sequential", "sequential",
                             "sequential"),
    ("vmap", "cpu"): ("vmap", "vmap", "vmap", "vmap"),
    ("vmap", "cuda"): ("vmap", "vmap", "vmap", "vmap"),
}


def test_auto_rule():
    """"auto": sequential on the CPU, AUTO_CUDA_CHAIN_EXEC on CUDA, and
    AUTO_EXACT's answer on every row (a mesh adds its own rule; the blocked
    sweep none)."""
    assert port_mcmc.AUTO_CUDA_CHAIN_EXEC == "sequential"
    assert _port(chain_exec="auto").chain_exec == "sequential"
    for (chain_exec, device), want in AUTO_EXACT.items():
        got = tuple(port_mcmc.resolve_chain_exec(
            chain_exec, device, mesh=mesh, gibbs_block=block)
            for mesh in (None, object()) for block in (0, 8))
        assert got == want, (chain_exec, device)
