"""The port's own randomness (TorchDraws) on a whole chain, held to
bnpc_tpu in distribution.

Every other chain-level test of the port replays bnpc_tpu's draws
(JaxDraws) and demands equal steps; this one runs both samplers on their
own generators, as tests/test_distributional_parity.py runs the reference
against bnpc_tpu: the 5-cell matrix, fixed errors and alpha, long chains,
and the total-variation distance of the partition frequencies and of the
cluster-count posterior. Calibration (`python -m
tests.test_torch_distribution`: 15,000 steps, 1,500 burn-in, seeds 17 and
18 of each sampler, CPU): port against bnpc_tpu TV 0.022-0.027, bnpc_tpu
against itself 0.017, the port against itself 0.027; every cluster-count
probability within 0.019. The bounds are about twice that Monte-Carlo
noise. Slow: the port's chain takes ~190 s on one CPU core.
"""

from collections import Counter

import pytest
import torch

from tests.test_distributional_parity import _freqs, _tiny_data

STEPS = 15000
BURN = 1500


def _run_port(data, seed=17):
    from bnpc_tpu_torch.config import MCMCConfig, ModelConfig
    from bnpc_tpu_torch.data import pack_data
    from bnpc_tpu_torch.mcmc import MCMCRunner

    torch.set_num_threads(1)
    n, m = data.shape
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=n, p=0.25, q=0.25,
                      fp=0.01, fn=0.1)
    mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.0, error_prob=0.0, sm_steps=3)
    runner = MCMCRunner(cfg, mc, pack_data(data, "cpu"), device="cpu",
                        block_size=5000)
    return runner.run((STEPS, BURN), seed=seed)[0].assignments[BURN:]


def _run_jax(data, seed=17):
    from bnpc_tpu.config import MCMCConfig, ModelConfig
    from bnpc_tpu.data import pack_data
    from bnpc_tpu.mcmc import MCMCRunner

    n, m = data.shape
    cfg = ModelConfig(n_cells=n, n_muts=m, k_max=n, p=0.25, q=0.25,
                      fp=0.01, fn=0.1)
    mc = MCMCConfig(sm_prob=0.33, dpa_prob=0.0, error_prob=0.0, sm_steps=3)
    runner = MCMCRunner(cfg, mc, pack_data(data), block_size=5000)
    return runner.run((STEPS, BURN), seed=seed, n_chains=1)[0] \
        .assignments[BURN:]


def _k_dist(freqs):
    d = Counter()
    for part, p in freqs.items():
        d[len(set(part))] += p
    return d


def _tv(fa, fb):
    keys = set(fa) | set(fb)
    return 0.5 * sum(abs(fa.get(k, 0) - fb.get(k, 0)) for k in keys)


@pytest.mark.slow
def test_torchdraws_partition_posterior_matches_jax():
    data = _tiny_data()
    fj, fp = _freqs(_run_jax(data)), _freqs(_run_port(data))
    keys = set(fj) | set(fp)
    tv = _tv(fj, fp)
    assert tv < 0.05, f"TV distance {tv:.4f}"
    for k in sorted(keys, key=lambda k: -fj.get(k, 0))[:6]:
        assert abs(fj.get(k, 0) - fp.get(k, 0)) < 0.025, \
            (k, fj.get(k, 0), fp.get(k, 0))
    kj, kp = _k_dist(fj), _k_dist(fp)
    for k in set(kj) | set(kp):
        assert abs(kj.get(k, 0) - kp.get(k, 0)) < 0.03, (k, kj, kp)


if __name__ == "__main__":
    # The calibration: TV and the largest cluster-count difference of
    # every pair of chains, two seeds of each sampler.
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    data = _tiny_data()
    runs = {f"{name}{seed}": _freqs(run(data, seed))
            for seed in (17, 18)
            for name, run in (("port", _run_port), ("jax", _run_jax))}
    names = sorted(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ka, kb = _k_dist(runs[a]), _k_dist(runs[b])
            dk = max(abs(ka.get(k, 0) - kb.get(k, 0))
                     for k in set(ka) | set(kb))
            print(f"{a} {b}: TV {_tv(runs[a], runs[b]):.4f}, "
                  f"max cluster-count difference {dk:.4f}")
