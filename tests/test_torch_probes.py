"""The port's probes against the JAX package's TPU probes.

* vecflow_ref (the CPU side of csrc/vecflow_probe.cu) against
  benchmarks/vecflow_probe.py::vecflow in interpret mode: no birth, a birth
  mid-batch (the rest of that batch compared), and n not a multiple of 128
  (the inert tail positions compared). Exact; rows the kernel never writes
  are not compared.
* while_exit_ref (the CPU side of csrc/while_probe.cu) against the inline
  Pallas kernel of benchmarks/mosaic_while_probe.py, run through its own
  main() with pallas_call patched to interpret mode: the probe verbatim (NaN
  sizes, i0 0), and finite sizes with a birth, from i0 0 and from i0 > 0.
  For a finite case the patch passes the case's sizes as a fourth input,
  copied into the kernel's sizes output before the probe's body runs, and
  feeds the case's z, perm and i0. Exact, NaN as NaN;
  info[:2] and the targets of positions [i0, info[0]).
* vecflow_ref against cuda_gibbs.lazy_segment_ref on a no-birth input, as
  the TPU probe's main() compares the two kernels.
"""

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import benchmarks.mosaic_while_probe as jwhile
import benchmarks.vecflow_probe as jvec
from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment_ref
from bnpc_tpu_torch.probes import vecflow_probe, while_probe
from bnpc_tpu_torch.probes.vecflow_probe import n_batches, vecflow_ref
from bnpc_tpu_torch.probes.while_probe import while_exit_ref

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# vecflow
# ---------------------------------------------------------------------------


def _vecflow_case(case):
    """(z, aux, assign, perm, sizes, log_denom, birth position or None)."""
    n, k_pad = {"no_birth": (384, 128), "birth_mid_batch": (384, 128),
                "ragged_tail": (300, 256)}[case]
    rng = np.random.default_rng({"no_birth": 0, "birth_mid_batch": 1,
                                 "ragged_tail": 2}[case])
    z = (rng.standard_normal((-(-n // 8) * 8, k_pad)) * 3.0).astype(
        np.float32)
    assign = rng.integers(0, 12, n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    sizes = np.full(k_pad, -1.0, np.float32)
    sizes[:12] = np.bincount(assign, minlength=12)
    sizes[20:24] = 0.0  # free slots, after padded ones
    aux = np.full(n, -np.inf, np.float32)
    birth = None
    if case == "birth_mid_batch":
        birth = 150  # batch 1, position 22 of 128
        aux[perm[birth]] = 1e30
    return z, aux, assign, perm, sizes, np.float32(8.5), birth


@pytest.mark.parametrize("case", ["no_birth", "birth_mid_batch",
                                  "ragged_tail"])
def test_vecflow_ref_matches_pallas(case):
    z, aux, assign, perm, sizes, log_denom, birth = _vecflow_case(case)
    n = assign.shape[0]
    j_tgt, j_sizes, j_info = (np.asarray(x) for x in jvec.vecflow(
        jnp.asarray(z), jnp.asarray(aux), jnp.asarray(assign),
        jnp.asarray(perm), jnp.asarray(sizes)[None], float(log_denom),
        interpret=True))

    tgt = torch.full((n_batches(n), 128), -7.0)
    t_sizes = _t(sizes).clone()
    info = torch.empty((1,), dtype=torch.int32)
    vecflow_ref(_t(z), _t(aux), _t(assign), _t(perm), t_sizes, tgt, info,
                torch.tensor(log_denom))

    want_info = n if birth is None else birth
    assert int(j_info[0]) == int(info[0]) == want_info
    np.testing.assert_array_equal(t_sizes.numpy(), j_sizes[0])
    rows = n_batches(n) if birth is None else birth // 128 + 1
    np.testing.assert_array_equal(tgt.numpy()[:rows], j_tgt[:rows])
    assert (tgt.numpy()[rows:] == -7.0).all()  # never written
    if birth is not None:
        # The newborn took the first free slot.
        assert tgt[birth // 128, birth % 128] == 20.0
        assert j_sizes[0, 20] > 0
    if case == "ragged_tail":
        assert rows * 128 > n  # inert tail positions were compared


def test_vecflow_ref_matches_lazy_segment_ref():
    n, k_pad = 300, 128
    z, aux, assign, perm, sizes0, log_denom = vecflow_probe.make_inputs(
        n, k_pad, "cpu")
    tgt_v = torch.full((n_batches(n), 128), -7.0)
    info_v = torch.empty((1,), dtype=torch.int32)
    sizes_v = sizes0.clone()
    vecflow_ref(z, aux, assign, perm, sizes_v, tgt_v, info_v, log_denom)
    tgt_l = torch.empty((n,), dtype=torch.int32)
    info_l = torch.empty((4,), dtype=torch.int32)
    sizes_l = sizes0.clone()
    lazy_segment_ref(z[:n], aux, assign, perm, sizes_l, tgt_l, info_l, 0,
                     log_denom)
    torch.testing.assert_close(tgt_v.reshape(-1)[:n].to(torch.int32), tgt_l,
                               rtol=0, atol=0)
    torch.testing.assert_close(sizes_v, sizes_l, rtol=0, atol=0)
    assert int(info_v[0]) == int(info_l[0]) == n


# ---------------------------------------------------------------------------
# while_exit
# ---------------------------------------------------------------------------

W_N, W_K = 512, 256  # the TPU probe's shape


def _run_pallas_while(monkeypatch, sizes=None, z=None, perm=None, i0=0):
    """Run benchmarks/mosaic_while_probe.py::main in interpret mode and
    return (z, perm, i0, out, sizes, info) as it ran. With `sizes`, the
    body first copies them into its sizes output, and z, perm and i0 replace
    the probe's own inputs."""
    orig = jpl.pallas_call
    seen = {}

    def patched(kernel, **kw):
        body = kernel
        if sizes is not None:
            # The sizes come in as a fourth input, copied into the sizes
            # output before the probe's body runs.
            kw["in_specs"] = [*kw["in_specs"],
                              jpl.BlockSpec(memory_space=pltpu.VMEM)]

            def body(z_ref, perm_ref, i0_ref, sizes_ref, out_ref,
                     sizes_out_ref, info_ref, *scratch):
                sizes_out_ref[...] = sizes_ref[...]
                kernel(z_ref, perm_ref, i0_ref, out_ref, sizes_out_ref,
                       info_ref, *scratch)

        call = orig(body, interpret=True, **kw)

        def run(*args):
            if sizes is not None:
                args = (z, perm, np.array([i0], np.int32))
            seen["args"] = [np.asarray(a) for a in args]
            extra = () if sizes is None else (jnp.asarray(sizes)[None],)
            seen["out"] = call(*args, *extra)
            return seen["out"]

        return run

    monkeypatch.setattr(jpl, "pallas_call", patched)
    jwhile.main()
    z_run, perm_run, i0_run = seen["args"]
    out, j_sizes, info = (np.asarray(x) for x in seen["out"])
    return z_run, perm_run, int(i0_run[0]), out, j_sizes[0], info


def _while_case(case):
    """(z, perm, sizes, i0, birth position) of a finite-size case."""
    rng = np.random.default_rng({"birth": 10, "late_i0": 11}[case])
    z = rng.normal(size=(W_N, W_K)).astype(np.float32)
    perm = rng.permutation(W_N).astype(np.int32)
    sizes = np.full(W_K, -1.0, np.float32)
    sizes[:40] = rng.integers(1, 30, 40)
    sizes[[0, 17]] = 0.0  # slot 0 empty: v[0] can beat the best logit
    i0, birth = {"birth": (0, 100), "late_i0": (200, 350)}[case]
    z[perm[birth], 0] = 50.0
    return z, perm, sizes, i0, birth


@pytest.mark.parametrize("case", ["verbatim", "birth", "late_i0"])
def test_while_exit_ref_matches_pallas(monkeypatch, case):
    if case == "verbatim":
        z, perm, i0, j_out, j_sizes, j_info = _run_pallas_while(monkeypatch)
        sizes = np.full(W_K, np.nan, np.float32)  # the unwritten output
        birth = None
    else:
        z, perm, sizes, i0, birth = _while_case(case)
        z, perm, i0, j_out, j_sizes, j_info = _run_pallas_while(
            monkeypatch, sizes=sizes, z=z, perm=perm, i0=i0)

    out = torch.full((W_N,), -7, dtype=torch.int32)
    t_sizes = _t(sizes).clone()
    info = torch.empty((4,), dtype=torch.int32)
    while_exit_ref(_t(z), _t(perm), t_sizes, out, info, i0)

    np.testing.assert_array_equal(info.numpy()[:2], j_info[:2])
    assert info.tolist()[2:] == [-1, -1]
    i_next = int(j_info[0])
    np.testing.assert_array_equal(out.numpy()[i0:i_next], j_out[i0:i_next])
    assert (out.numpy()[:i0] == -7).all() and (out.numpy()[i_next:] == -7
                                               ).all()
    np.testing.assert_array_equal(t_sizes.numpy(), j_sizes)  # NaN == NaN
    if birth is None:
        assert j_info[:2].tolist() == [W_N, -1]
        assert np.isnan(j_sizes).all() and (j_out == 0).all()
    else:
        assert j_info[:2].tolist() == [birth + 1, int(perm[birth])]
        assert j_out[birth] == 0  # the first free slot


# ---------------------------------------------------------------------------
# The probes' entry points and wrappers
# ---------------------------------------------------------------------------


def test_probe_mains_run_on_cpu():
    assert vecflow_probe.main(["--device", "cpu"]) == {"n": 5000,
                                                       "k_pad": 256}
    res = while_probe.main(["--device", "cpu"])
    assert res["info"] == [512, -1, -1, -1]


def test_wrappers_refuse_other_devices():
    z = torch.zeros((8, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vecflow_probe.vecflow(z, *[None] * 7)
    with pytest.raises(ValueError, match="unsupported device"):
        while_probe.while_exit(z, *[None] * 4, 0)
