"""The reference and the frozen arithmetic on inputs worked out by hand."""

import math
import types

import numpy as np
import pytest
from scipy import stats

from portbench.lib import devtrace, ess, roofline
from portbench.reference import judge, model as ref

NAN = float("nan")
CONFIG = {"data": {"n_cells": 4, "n_muts": 2},
          "model": {"k_max": 3, "p": 0.25, "q": 0.25, "fp": 0.01, "fn": 0.2,
                    "fp_sd": 0.01, "fn_sd": 0.1, "learn_errors": True}}


def tiny():
    x = np.array([[1, 0], [1, NAN], [0, 0], [0, 1]])
    assign = np.array([0, 0, 2, 2])
    theta = np.array([[0.9, 0.2], [0.5, 0.5], [0.1, 0.3]])
    return x, assign, theta, 0.05, 0.1


def by_hand_ll(x, assign, theta, fp, fn):
    total = 0.0
    for i, k in enumerate(assign):
        for j, v in enumerate(x[i]):
            t = theta[k, j]
            if v == 1:
                total += math.log(t * (1 - fn) + (1 - t) * fp)
            elif v == 0:
                total += math.log(t * fn + (1 - t) * (1 - fp))
    return total


def test_loglik_against_hand():
    x, assign, theta, fp, fn = tiny()
    ones, zeros = ref.planes(x)
    n1, n0 = ref.cluster_counts(ones, zeros, assign, 3)
    assert n1.tolist() == [[2, 0], [0, 0], [0, 1]]
    assert n0.tolist() == [[0, 1], [0, 0], [2, 1]]
    assert ref.loglik(ones, zeros, assign, theta, fp, fn) == \
        pytest.approx(by_hand_ll(x, assign, theta, fp, fn), rel=1e-14)


def test_log_prior_against_hand():
    x, assign, theta, fp, fn = tiny()
    mdl = ref.Model(CONFIG)
    sizes = np.array([2, 0, 2])
    alpha = 2.5
    want = stats.gamma(2.0, loc=1.0).logpdf(alpha)  # sqrt(4) = 2
    want += 2 * (math.log(2) - math.log(4 - 1 + alpha))
    for k in (0, 2):
        want += stats.beta(0.25, 0.25).logpdf(theta[k]).sum()
    for v, mu, sd in ((fp, 0.01, 0.01), (fn, 0.2, 0.1)):
        a, b = (0 - mu) / sd, (1 - mu) / sd
        z = stats.norm.cdf(b) - stats.norm.cdf(a)
        want += stats.norm.logpdf(v, mu, sd) - math.log(z)
    got = ref.log_prior(mdl, sizes, theta, alpha, fp, fn)
    assert got == pytest.approx(want, rel=1e-12)


def test_cell_gaps_against_hand():
    x, assign, theta, fp, fn = tiny()
    ones, zeros = ref.planes(x)
    sizes = np.array([2, 0, 2])
    gaps = ref.cell_gaps(ones, zeros, assign, theta, sizes, fp, fn)
    for i, own in enumerate(assign):
        scores = {k: math.log(sizes[k]) + by_hand_ll(x[i:i + 1], [k], theta,
                                                     fp, fn)
                  for k in (0, 2)}
        assert gaps[i] == pytest.approx(max(scores.values()) - scores[own],
                                        abs=1e-12)
    with pytest.raises(ValueError):
        ref.cell_gaps(ones, zeros, np.array([1, 0, 2, 2]), theta, sizes, fp,
                      fn)


def test_control_reads_a_bfloat16_gap():
    rng = np.random.default_rng(0)
    x = (rng.random((300, 200)) < 0.4).astype(float)
    assign = rng.integers(0, 4, 300)
    theta = rng.uniform(0.05, 0.95, (4, 200)).astype(np.float32)
    ones, zeros = ref.planes(x)
    exact = ref.loglik(ones, zeros, assign, theta, 0.01, 0.2)
    lower = ref.loglik_lower(ones, zeros, assign, theta, 0.01, 0.2)
    assert 1e-5 < abs(lower - exact) / abs(exact) < 0.05


def test_ess_against_its_source_and_known_traces():
    from bnpc_tpu_torch.diagnostics import effective_sample_size

    rng = np.random.default_rng(1)
    ar = np.zeros(2000)
    for t in range(1, ar.size):
        ar[t] = 0.9 * ar[t - 1] + rng.normal()
    for trace in (ar, rng.normal(size=500), np.arange(50.0)):
        assert ess.effective_sample_size(trace) == \
            effective_sample_size(trace)
    # AR(1) with phi 0.9: tau = (1 + phi) / (1 - phi) = 19.
    assert ess.effective_sample_size(ar) == pytest.approx(2000 / 19,
                                                          rel=0.35)
    assert ess.effective_sample_size(np.ones(20)) == 20.0
    assert ess.effective_sample_size([1.0, 2.0, 3.0]) == 3.0


def test_roofline_counts():
    assert roofline.lazy_k_pad(256) == 256
    assert roofline.lazy_k_pad(100) == 128
    b, ops = roofline.lazy_segment_work(5000, 256, 2, 3)
    assert b == 4 * 2 * (5000 * 256 + 4 * 5000) + 4 * 3 * (2 * 256 + 4)
    assert ops == 6 * 2 * 5000 * 256
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def _event(name, start, dur, cuda):
    from torch.autograd import DeviceType

    dev = DeviceType.CUDA if cuda else DeviceType.CPU
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: dur,
                                 device_type=lambda: dev)


def test_trace_reduction_on_a_crafted_trace():
    events = [
        _event("outer", 0, 100_000, False),
        _event("cudaLaunchKernel", 1_000, 1_000, False),
        _event("cudaGraphLaunch", 2_000, 1_000, False),
        _event("aten::item", 40_000, 30_000, False),
        _event("void lazy_segment_kernel<8>(float const*)", 5_000, 20_000,
               True),
        _event("elementwise", 20_000, 10_000, True),   # overlaps
        _event("elementwise", 80_000, 10_000, True),
    ]
    out = devtrace.reduce_events(events, 1e-4)
    assert out["host_launches"] == 2
    assert out["busy_s"] == pytest.approx(35_000e-9)
    assert out["kernels"]["elementwise"] == [2, pytest.approx(20_000e-9)]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(50_000e-9)   # 30k-80k
    assert gaps["cudaGraphLaunch"] == pytest.approx(5_000e-9)  # 0-5k
    assert gaps["outer"] == pytest.approx(10_000e-9)           # 90k-100k
    assert out["device_ops"][0][0] == "lazy_segment_kernel<8>"
    card_name = ("void (anonymous namespace)::stream_reg_kernel<4>(float "
                 "const*, int*, int, int)")
    assert devtrace.kernel_base(card_name) == "stream_reg_kernel"
    assert devtrace.short_name(card_name) == "stream_reg_kernel<4>"
    torch_name = ("std::enable_if<!(false), void>::type internal::gpu_"
                  "kernel_impl<at::native::Functor<float>>(at::TensorIter"
                  "atorBase&)")
    assert devtrace.kernel_base(torch_name) == "gpu_kernel_impl"
    assert devtrace.short_name(torch_name).startswith(
        "internal::gpu_kernel_impl<at::native::Functor")
    assert devtrace.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH"
    hand = devtrace.handwritten_kernels(devtrace.Path(__file__).parents[2])
    assert "lazy_segment_kernel" in hand and "rg_scan_kernel" in hand
    assert devtrace.is_handwritten(events[4].name(), hand)


def test_stuck_rows_and_move_counts():
    steps, n, m = 4, 5, 3
    rows = {"ml": np.array([1.0, 2.0, 2.0, 3.0]),
            "map_": np.array([1.0, 2.0, 2.0, 3.0]),
            "dp_alpha": np.ones(steps), "fp": np.ones(steps),
            "fn": np.ones(steps),
            "assignment": np.zeros((steps, n), dtype=np.uint8),
            "mh_counts": np.zeros((steps, 5, 2), dtype=np.int32)}
    rows["mh_counts"][:, 0, 0] = m   # one live cluster, m loci
    got = judge.rows_numbers(rows, None, m)
    assert got == {"mismatches": 0, "stuck_share": pytest.approx(1 / 3)}
    rows["mh_counts"][1, 1] = 1       # a split and a merge in one step
    rows["mh_counts"][2, 3, 0] = 1    # FP moved without FN
    assert judge.rows_numbers(rows, None, m)["mismatches"] == 2
