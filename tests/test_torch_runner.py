"""The port's runner against bnpc_tpu's MCMCRunner: multi-chain runs,
coupled moves, time and lugsail modes, checkpoint / resume.

The port runs on an injected root provider (JaxDraws), so its key tree is
bnpc_tpu's: the same initial states and the same step keys. Compared on
whole runs: assignments and MH counts exactly; ML, and the log prior
(MAP - ML; ROADMAP queue 3 says why MAP alone is not), to rtol 1e-5, atol
1e-4; the kept params rows to rtol 1e-3 (both record f16) after aligning
widths (bnpc_tpu slices its params trace to the live width, the port keeps
trace_k columns). Resume equality, chain seeds and the params trim run on
the port's own draws (TorchDraws), bit for bit.

bnpc_tpu's runner compiles one program per block length, ~30-45 s each on
the CPU, so every bnpc_tpu run here shares one runner and one block length
(BLOCK): the lugsail runs take extensions of BLOCK steps, not 200.
"""

import functools
from datetime import datetime, timedelta

import jax
import numpy as np
import pytest
import torch

from bnpc_tpu import mcmc as jax_mcmc
from bnpc_tpu.config import MCMCConfig as JMCMCConfig
from bnpc_tpu.data import pack_data
from bnpc_tpu_torch import mcmc as port_mcmc
from bnpc_tpu_torch.config import MCMCConfig
from bnpc_tpu_torch.data import pack_data as port_pack
from tests.torch_parity import JaxDraws, configs, make_problem

torch.set_num_threads(1)

N, M, BLOCK = 24, 12, 10
MODEL = dict(p=0.25, q=0.25, fp=0.01, fn=0.2, learn_errors=True, fp_sd=0.01,
             fn_sd=0.1)
MIX = dict(sm_prob=0.33, dpa_prob=0.25, error_prob=0.25, sm_steps=2)
DATA, _ = make_problem(n=N, m=M, k_clones=3, seed=1)
JCFG, TCFG = configs(N, M, N, **MODEL)


@pytest.fixture(scope="module")
def jax_runner():
    """bnpc_tpu's runner with its default CPU chain exec (vmap)."""
    return jax_mcmc.MCMCRunner(JCFG, JMCMCConfig(**MIX), pack_data(DATA),
                               block_size=BLOCK)


def _port(block=BLOCK, ckpt=None, **mix):
    return port_mcmc.MCMCRunner(TCFG, MCMCConfig(**{**MIX, **mix}),
                                port_pack(DATA, "cpu"), device="cpu",
                                block_size=block, checkpoint_dir=ckpt,
                                checkpoint_every=1)


def _short_lugsail(monkeypatch, *runners):
    """Lugsail extensions of BLOCK steps in both packages (one compiled
    block length for bnpc_tpu)."""
    for cls in runners:
        monkeypatch.setattr(cls, "_run_lugsail", functools.partialmethod(
            cls._run_lugsail, extension=BLOCK))


def assert_matches_jax(jres, pres):
    assert len(jres) == len(pres)
    for j, p in zip(jres, pres):
        np.testing.assert_array_equal(j.assignments, p.assignments)
        np.testing.assert_array_equal(j.mh_counts, p.mh_counts)
        assert j.burn_in == p.burn_in
        np.testing.assert_allclose(p.ML, j.ML, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(p.MAP - p.ML, j.MAP - j.ML, rtol=1e-5,
                                   atol=1e-4)
        w = j.params.shape[1]
        assert p.params.shape[0] == j.params.shape[0]
        np.testing.assert_allclose(p.params[:, :w], j.params, rtol=1e-3)
        assert not p.params[:, w:].any()
        assert [s for s, _ in p.PSRF] == [s for s, _ in j.PSRF]
        np.testing.assert_allclose([v for _, v in p.PSRF],
                                   [v for _, v in j.PSRF], rtol=1e-6)


def assert_same(a, b):
    """Two port results, bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("ML", "MAP", "DP_alpha", "FN", "FP", "assignments",
                  "params", "mh_counts"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
        assert (x.burn_in, x.PSRF) == (y.burn_in, y.PSRF)


# ---------------------------------------------------------------------------
# Against bnpc_tpu
# ---------------------------------------------------------------------------


def test_chains_match_jax(jax_runner):
    """2 independent chains, 16 steps in blocks of 10 (the last one
    partial: a whole block's keys, 6 steps run), burn-in 4."""
    want = jax_runner.run((16, 4), seed=3, n_chains=2, verbosity=0)
    runner = _port()
    got = runner.run((16, 4), n_chains=2, draws=JaxDraws(jax.random.key(3)))
    assert_matches_jax(want, got)
    np.testing.assert_array_equal(runner.seeds, jax_runner.seeds)
    kinds = sum(r.mh_counts for r in got)
    assert kinds[1].sum() + kinds[2].sum() > 0 and got[0].params.shape[0] == 13


def test_coupled_chains_match_jax():
    import dataclasses

    jr = jax_mcmc.MCMCRunner(JCFG, dataclasses.replace(
        JMCMCConfig(**MIX), coupled_moves=True), pack_data(DATA),
        block_size=BLOCK, chain_exec="vmap")
    want = jr.run((16, 4), seed=5, n_chains=2, verbosity=0)
    got = _port(coupled_moves=True).run((16, 4), n_chains=2,
                                        draws=JaxDraws(jax.random.key(5)))
    assert_matches_jax(want, got)


class _FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0) if len(self.times) > 1 else self.times[0]


def _clock(t0, *seconds):
    return _FakeClock([t0 + timedelta(seconds=s) for s in seconds])


def test_time_mode_matches_jax(jax_runner):
    """One fake clock for both runners (readings per block: loop check,
    block start, block end): blocks 0-4 s, 4-8 s, 8-12 s against a 10 s
    deadline (the last block keeps int(10 * 2 / 4) = 5 rows) and a 6 s
    burn-in (step 10 + int(10 * 2 / 4) = 15)."""
    t0 = datetime(2026, 1, 1)
    readings = (0, 0, 4, 4, 4, 8, 8, 8, 12, 12)
    runner = _port()
    jax_runner._now = _clock(t0, *readings)
    runner._now = _clock(t0, *readings)
    run_var = (t0 + timedelta(seconds=10), t0 + timedelta(seconds=6))
    want = jax_runner.run(run_var, seed=8, n_chains=2, verbosity=0)
    got = runner.run(run_var, n_chains=2, draws=JaxDraws(jax.random.key(8)))
    assert got[0].ML.shape == (26,) and got[0].burn_in == 15
    assert_matches_jax(want, got)


def test_lugsail_matches_jax(jax_runner, monkeypatch):
    _short_lugsail(monkeypatch, jax_mcmc.MCMCRunner,
                   port_mcmc.MCMCRunner)
    want = jax_runner.run((1.05, 0), seed=6, n_chains=2, verbosity=0)
    got = _port().run((1.05, 0), n_chains=2,
                      draws=JaxDraws(jax.random.key(6)))
    assert len(got[0].PSRF) >= 3 and got[0].PSRF[-1][1] <= 1.05
    assert got[0].burn_in == got[0].ML.size // 2 + 1
    assert_matches_jax(want, got)


@pytest.mark.parametrize("source", ["bnpc_tpu", "other_device"])
def test_foreign_checkpoint_refused(source, jax_runner, tmp_path):
    path = tmp_path / "mcmc_state.npz"
    if source == "bnpc_tpu":
        states = jax_runner.init_chains(jax.random.key(0), 2)
        jax_runner.save_checkpoint(str(path), states,
                                   jax.random.split(jax.random.key(1), 2),
                                   jax_mcmc._TraceBuffer(2), 0)
    else:
        _port(block=5, ckpt=str(tmp_path)).run((5, 1), seed=0, n_chains=2)
        with np.load(path) as z:
            payload = dict(z)
        payload["generator_device"] = np.asarray("cuda")
        np.savez(path, **payload)
    with pytest.raises(ValueError, match=str(path)):
        _port(block=5, ckpt=str(tmp_path)).run((10, 1), seed=0, n_chains=2)


# ---------------------------------------------------------------------------
# The port's own draws
# ---------------------------------------------------------------------------


def test_chain_seeds():
    """Chain c of a 3-chain run is the one-chain run with seed seeds[c]."""
    runner = _port(block=5)
    res = runner.run((12, 3), seed=11, n_chains=3)
    seeds = runner.seeds
    assert seeds.shape == (3,) and len(set(seeds.tolist())) == 3
    for c in range(3):
        assert_same([res[c]], _port(block=5).run((12, 3), seed=int(seeds[c])))


@pytest.mark.parametrize("steps", [30, 27])
def test_steps_resume(steps, tmp_path):
    """A 20-step run (blocks of 5, a checkpoint every block) resumed by a
    fresh runner to `steps` equals the uninterrupted run: aligned, and a
    partial final block after the block-aligned checkpoint."""
    ck = str(tmp_path / "ck")
    _port(block=5, ckpt=ck).run((20, 4), seed=2, n_chains=2)
    with np.load(tmp_path / "ck" / "mcmc_state.npz") as z:
        assert int(z["done"]) == 20
    resumed = _port(block=5, ckpt=ck).run((steps, 4), seed=2, n_chains=2)
    assert_same(resumed, _port(block=5).run((steps, 4), seed=2, n_chains=2))
    if steps % 5:
        with np.load(tmp_path / "ck" / "mcmc_state.npz") as z:
            assert int(z["done"]) == 25


def test_time_resume(tmp_path):
    """Time mode: two blocks, a checkpoint after each (one more clock
    reading each), then a reading past the deadline; a fresh runner
    resumes for a third. Equals the uninterrupted three blocks, burn-in
    (1.5 s: step 5 + int(5 * 0.5) = 7) included."""
    t0 = datetime(2026, 1, 1)
    run_var = (t0 + timedelta(seconds=50), t0 + timedelta(seconds=1.5))
    ck = str(tmp_path / "ck")
    r1 = _port(block=5, ckpt=ck)
    r1._now = _clock(t0, 0, 0, 1, 1, 1, 1, 2, 2, 100)
    first = r1.run(run_var, seed=6, n_chains=2)
    assert first[0].ML.size == 11
    r2 = _port(block=5, ckpt=ck)
    r2._now = _clock(t0, 2, 2, 3, 3, 100)
    r3 = _port(block=5)
    r3._now = _clock(t0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 100)
    resumed = r2.run(run_var, seed=6, n_chains=2)
    assert resumed[0].ML.size == 16 and resumed[0].burn_in == 7
    assert_same(resumed, r3.run(run_var, seed=6, n_chains=2))


def test_lugsail_resume(tmp_path, monkeypatch):
    """Lugsail: a run that stops at its third PSRF evaluation, resumed by
    a fresh runner from the checkpoint of its second extension, equals the
    uninterrupted run, PSRF log included."""
    _short_lugsail(monkeypatch, port_mcmc.MCMCRunner)
    psrf = port_mcmc.diagnostics.lugsail_psrf
    calls = []

    def crashing(chains):
        calls.append(len(chains[0][0]))
        if len(calls) == 3:
            raise KeyboardInterrupt
        return psrf(chains)

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(port_mcmc.diagnostics, "lugsail_psrf", crashing)
    with pytest.raises(KeyboardInterrupt):
        _port(block=5, ckpt=ck).run((1.05, 0), seed=9, n_chains=2)
    assert calls == [11, 21, 31]
    monkeypatch.setattr(port_mcmc.diagnostics, "lugsail_psrf", psrf)
    resumed = _port(block=5, ckpt=ck).run((1.05, 0), seed=9, n_chains=2)
    full = _port(block=5).run((1.05, 0), seed=9, n_chains=2)
    assert len(full[0].PSRF) > 3
    assert_same(resumed, full)


@pytest.mark.parametrize("mode", ["steps", "lugsail"])
def test_params_trim(mode, monkeypatch):
    """The buffer keeps only post-burn-in params rows (lugsail: trimmed
    after every PSRF check to its growing burn-in), and the kept rows are
    those of an untrimmed run."""
    _short_lugsail(monkeypatch, port_mcmc.MCMCRunner)
    bufs = []

    class Buffer(port_mcmc._TraceBuffer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            bufs.append(self)

    monkeypatch.setattr(port_mcmc, "_TraceBuffer", Buffer)
    run_var = (23, 9) if mode == "steps" else (1.1, 0)
    res = _port(block=5).run(run_var, seed=12, n_chains=2)
    (buf,) = bufs
    kept = sum(r["params"].shape[1] for r in buf.rows)
    for r in res:
        assert kept == r.params.shape[0] == r.ML.size - r.burn_in
    monkeypatch.setattr(Buffer, "trim_params", lambda self, n: None)
    if mode == "steps":
        full = _port(block=5).run((23, 0), seed=12, n_chains=2)
    else:
        full = _port(block=5).run(run_var, seed=12, n_chains=2)
    assert sum(r["params"].shape[1] for r in bufs[-1].rows) > kept
    for a, b in zip(res, full):
        np.testing.assert_array_equal(a.params, b.params[-a.params.shape[0]:])
        np.testing.assert_array_equal(a.ML, b.ML)
