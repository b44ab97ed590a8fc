"""Whole runs on the CPU at a small size (the harness's look for a card
skipped): sound, ``correct`` is true; with the timed path broken underneath
it comes out false, once for each fault a cell can have."""

import json

import pytest
import torch

from bnpc_tpu_torch import estimators, mcmc
from bnpc_tpu_torch.ops import likelihood as lk
from bnpc_tpu_torch.state import cluster_stats
from portbench import run
from portbench.tests.conftest import small_cell


def _line(capsys, name, seconds="2"):
    rc = run.main(["--workload", name, "--seed", "2147483911", "--seconds",
                   seconds, "--trace", "0"], device="cpu",
                  cell=small_cell(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _steps(monkeypatch, broken_step):
    real = mcmc.make_step_fn

    def make(cfg, mcmc_cfg, data, trace_k, *args, **kwargs):
        step = real(cfg, mcmc_cfg, data, trace_k, *args, **kwargs)
        return lambda state, draws: broken_step(step, state, draws, data,
                                                cfg, trace_k)

    monkeypatch.setattr(mcmc, "make_step_fn", make)


def unchanged(step, state, draws, data, cfg, trace_k):
    """The step draws, then returns the state it was given."""
    _, row = step(state, draws)
    return state, mcmc.summarize(state, data, cfg, trace_k)._replace(
        mh_counts=row.mh_counts)


def altered(step, state, draws, data, cfg, trace_k):
    """Cell 0 lands in another live cluster, its row written to match."""
    state, row = step(state, draws)
    live = torch.nonzero(state.cluster_size > 0).flatten()
    old = int(state.assignment[0])
    new = int(live[live != old][0])
    a = state.assignment.clone()
    a[0] = new
    sizes = state.cluster_size.clone()
    sizes[old] -= 1
    sizes[new] += 1
    state = state._replace(assignment=a, cluster_size=sizes)
    return state, mcmc.summarize(state, data, cfg, trace_k)._replace(
        mh_counts=row.mh_counts)


def half(monkeypatch):
    """The log-likelihood over half of the cells, doubled."""
    real = mcmc.summarize

    def summarize(state, data, cfg, trace_k, stats=None, ax=mcmc._NO_AXIS):
        row = real(state, data, cfg, trace_k, stats, ax)
        h = data.n_cells // 2
        sub = data._replace(xm=data.xm[:h], xm0=data.xm0[:h],
                            rs1=data.rs1[:h], rs0=data.rs0[:h])
        n1, n0 = cluster_stats(sub, state.assignment[:h], cfg.k_max)
        c1, c0 = lk.log_prob_tables(state.params, state.fp, state.fn)
        ml = 2.0 * lk.ll_from_stats(n1, n0, c1, c0)
        return row._replace(ml=ml, map_=row.map_ - row.ml + ml)

    monkeypatch.setattr(mcmc, "summarize", summarize)


def moved_consensus(monkeypatch):
    """The posterior's consensus puts cell 0 into another cluster."""
    real = estimators.mpear_assignment

    def mpear(assignments, *args, **kwargs):
        labels = real(assignments, *args, **kwargs).copy()
        labels[0] = next(v for v in labels if v != labels[0])
        return labels

    monkeypatch.setattr(estimators, "mpear_assignment", mpear)


@pytest.mark.parametrize("name", ["bnpc5k.chain1", "bnpc5k.chains4",
                                  "bnpc5k.job512"])
def test_sound_small_run_is_correct(name, capsys):
    line = _line(capsys, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    ("bnpc5k.chain1", "unchanged"), ("bnpc5k.chain1", "altered"),
    ("bnpc5k.chain1", "half"), ("bnpc5k.job512", "unchanged"),
    ("bnpc5k.job512", "altered")])
def test_broken_path_is_not_correct(name, fault, capsys, monkeypatch):
    if fault == "half":
        half(monkeypatch)
    elif fault == "altered" and name.endswith("job512"):
        moved_consensus(monkeypatch)
    else:
        _steps(monkeypatch, {"unchanged": unchanged,
                             "altered": altered}[fault])
    line = _line(capsys, name)
    assert not line["correct"]
    assert line["failed"] > 0
