"""Plain models of the two probes' kernel designs, held against their twins.

The probes' CUDA kernels (bnpc_tpu_torch/csrc/while_probe.cu and
vecflow_probe.cu) run kernel 1's loop: a cp.async row ring, perm in
32-position chunks, the next position's inputs a position ahead. What each
computes is its plain twin (probes/while_probe.py::while_exit_ref,
probes/vecflow_probe.py::vecflow_ref); this file models, on the CPU, the
order and the arithmetic the kernels use and demands the twins' bits:

* kernel 6 (`NanChainModel`, `model_while_exit`): log weights w and wp
  cached beside the sizes with the one-logf `pend` refresh; every logit
  mapped to an order-preserving unsigned key, all NaNs to 0xffffffff; the
  max key and its first slot taken lane by lane and then across the warp;
  the first free slot only when the new-cluster option won. Against
  while_exit_ref exactly (targets, sizes NaN for NaN, info), and on two
  cases against the Pallas probe in interpret mode.
* kernel 5 (`model_vecflow`): the batches in 32-position chunks, the rows
  through a ring of kRing slots (a slot read after it was overwritten would
  give another row), the targets of a batch kept and written once, the
  birth tested once a batch, and the ragged batch's inert positions given
  one first argmax. The step is test_torch_chain.py's ChainModel, the model
  of gibbs_common.cuh::chain_step. Against vecflow_ref exactly, and on the
  birth-in-tail case against benchmarks/vecflow_probe.py::vecflow in
  interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.vecflow_probe as jvec
from bnpc_tpu_torch.probes import vecflow_probe
from bnpc_tpu_torch.probes.vecflow_probe import BATCH, n_batches, vecflow_ref
from bnpc_tpu_torch.probes.while_probe import (CRAFTED, NANS, crafted_inputs,
                                              while_exit_ref)
from tests.test_torch_chain import ChainModel, _key_values, key_of
from tests.test_torch_probes import _run_pallas_while

torch.set_num_threads(1)

NAN_KEY = np.uint32(0xFFFFFFFF)
K_RING = 8  # gibbs_common.cuh::kRing


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Kernel 6: the key map
# ---------------------------------------------------------------------------


def nan_key(x) -> np.ndarray:
    """while_probe.cu::nan_key: key_of, and 0xffffffff for every NaN."""
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore"):  # NaN + 0.0
        return np.where(np.isnan(x), NAN_KEY, key_of(x)).astype(np.uint32)


def test_nan_key_orders_finite_values_and_infinities():
    x = np.sort(_key_values())
    k = nan_key(x).astype(np.int64)
    assert ((np.diff(k) > 0) == (np.diff(x) > 0)).all()
    assert (np.diff(k) >= 0).all()
    assert nan_key(np.float32(-0.0)) == nan_key(np.float32(0.0))


def test_nan_key_puts_every_nan_above_inf():
    keys = nan_key(np.array(NANS))
    assert (keys == NAN_KEY).all()  # sign and payload do not matter
    assert nan_key(np.float32(np.inf)) == np.uint32(0xFF800000)
    assert NAN_KEY > nan_key(_key_values()).max()
    # The max of a row's keys is the NaN key iff the row holds a NaN, and
    # its first slot is the first NaN: jnp.max and jnp.argmax.
    row = np.array([1.0, np.inf, NANS[1], 3.0, NANS[0]], np.float32)
    k = nan_key(row)
    assert k.max() == NAN_KEY and int(np.flatnonzero(k == k.max())[0]) == 2
    assert int(jnp.argmax(jnp.asarray(row))) == 2


# ---------------------------------------------------------------------------
# Kernel 6: the step and the loop
# ---------------------------------------------------------------------------


def _nan_log_w(size: torch.Tensor) -> torch.Tensor:
    """log(s < 0 ? 0 : s): jnp.maximum's NaN, not fmaxf's."""
    return torch.log(torch.where(size < 0.0, torch.zeros_like(size), size))


class NanChainModel:
    """The carried state of while_probe.cu::NanChain and its step, one
    element per slot; slot s * 32 + l is lane l's element s."""

    def __init__(self, sizes: torch.Tensor):
        self.sz = sizes.clone()
        self.w = _nan_log_w(self.sz)
        self.wp = _nan_log_w(self.sz + 1.0)
        self.pend = -1
        self.free_reads = 0  # reductions for the first free slot

    def _warp_min(self, x: np.ndarray) -> int:
        # Each lane's first slot (its elements s), then the least lane's.
        return int(x.reshape(-1, 32).min(axis=0).min())

    def step(self, v: torch.Tensor):
        k = self.sz.shape[0]
        iota = np.arange(k)
        wp_fix = None
        if self.pend >= 0:  # started before the pick, off the chain
            p = self.pend
            wp_fix = _nan_log_w(self.sz[p:p + 1] + 1.0)[0]
        v0 = np.float32(v[0])
        v0_key = np.uint32(0) if np.isnan(v0) else key_of(v0)
        key = nan_key((v + self.w).numpy())
        best = key.reshape(-1, 32).max(axis=0).max()
        t = self._warp_min(np.where(key == best, iota, k))
        is_new = False
        if v0_key > best:  # only now is the free slot needed
            self.free_reads += 1
            free = self._warp_min(np.where(self.sz.numpy() == 0.0, iota, k))
            is_new = free < k
            if is_new:
                t = free
        if self.pend >= 0:
            self.wp[self.pend] = wp_fix
        self.sz[t] += 1.0
        self.w[t] = self.wp[t]
        self.pend = t
        return t, is_new


def model_while_exit(z, perm, sizes, out, info, i0: int):
    """while_exit_ref's interface on NanChainModel."""
    n = perm.shape[0]
    perm_h = perm.tolist()
    st = NanChainModel(sizes)
    i_next, b_cell = n, -1
    for i in range(i0, n):
        t, is_new = st.step(z[perm_h[i]])
        out[i] = t
        if is_new:
            i_next, b_cell = i + 1, perm_h[i]
            break
    # The twin adds 0.0 to every slot of a visited cell (-0.0 -> +0.0).
    sizes.copy_(st.sz + 0.0 if i0 < n else st.sz)
    info.copy_(torch.tensor([i_next, b_cell, -1, -1], dtype=torch.int32))
    return st


def _run_while(fn, z, perm, sizes, i0):
    n = perm.shape[0]
    out = torch.full((n,), -7, dtype=torch.int32)
    t_sizes = _t(sizes).clone()
    info = torch.zeros((4,), dtype=torch.int32)
    st = fn(_t(z), _t(perm), t_sizes, out, info, i0)
    return out, t_sizes, info, st


def _assert_while_same(got, want):
    (mo, ms, mi), (ro, rs, ri) = got[:3], want[:3]
    assert mi.tolist() == ri.tolist()
    assert torch.equal(mo, ro)
    torch.testing.assert_close(ms, rs, rtol=0, atol=0, equal_nan=True)
    # Bit for bit where not NaN: -0.0 and +0.0 differ here.
    fin = ~torch.isnan(rs)
    assert torch.equal(ms[fin].view(torch.int32), rs[fin].view(torch.int32))


WHILE_CASES = [c for c in CRAFTED if c != "random"]


@pytest.mark.parametrize("name", WHILE_CASES)
def test_while_model_equals_twin(name):
    z, perm, sizes, i0, want = crafted_inputs(name)
    model = _run_while(model_while_exit, z, perm, sizes, i0)
    twin = _run_while(while_exit_ref, z, perm, sizes, i0)
    _assert_while_same(model, twin)
    if want is not None:
        assert model[2].tolist()[:2] == want
    if name == "signed_zero_ties":
        assert (model[0][i0:] == 3).all()  # the first of the tied slots
        assert not torch.signbit(model[1][20])  # -0.0 left as +0.0
    if name == "sizes_minus_one":
        # The NaN logit's slot took its cell: -1 + 1.
        cell6 = int(model[0][6])
        assert cell6 == z.shape[1] - 1 and model[1][cell6] == 0.0


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_while_model_equals_twin_every_width(k):
    z, perm, sizes, i0, _ = crafted_inputs("random", n=96, k_pad=k)
    model = _run_while(model_while_exit, z, perm, sizes, i0)
    twin = _run_while(while_exit_ref, z, perm, sizes, i0)
    _assert_while_same(model, twin)
    # The free slot was reduced only for a cell whose option won.
    assert model[3].free_reads <= int(model[2][0]) - i0


def test_while_model_cached_weights_follow_sizes():
    """After a run, w and wp (but the pending slot's wp) are what they
    would be computed afresh from the sizes, NaN for NaN."""
    z, perm, sizes, i0, _ = crafted_inputs("random", n=96, k_pad=64)
    st = _run_while(model_while_exit, z, perm, sizes, i0)[3]
    torch.testing.assert_close(st.w, _nan_log_w(st.sz), rtol=0, atol=0,
                               equal_nan=True)
    keep = torch.arange(64) != st.pend
    torch.testing.assert_close(st.wp[keep], _nan_log_w(st.sz + 1.0)[keep],
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["nan_signs_payloads", "birth_at_last"])
def test_while_model_equals_pallas(monkeypatch, name):
    z, perm, sizes, i0, want = crafted_inputs(name, n=512, k_pad=256)
    _, _, _, j_out, j_sizes, j_info = _run_pallas_while(
        monkeypatch, sizes=sizes, z=z, perm=perm, i0=i0)
    out, t_sizes, info, _ = _run_while(model_while_exit, z, perm, sizes, i0)
    assert info.tolist()[:2] == j_info[:2].tolist() == want
    i_next = int(j_info[0])
    np.testing.assert_array_equal(out.numpy()[i0:i_next], j_out[i0:i_next])
    np.testing.assert_array_equal(t_sizes.numpy(), j_sizes)  # NaN == NaN


# ---------------------------------------------------------------------------
# Kernel 5: the loop order
# ---------------------------------------------------------------------------


def model_vecflow(z, aux, assign, perm, sizes, tgt, info, log_denom):
    """vecflow_ref's interface on vecflow_probe.cu's loop: chunks of 32
    positions, rows through the ring, targets written once a batch, the
    birth tested once a batch, one inert target for the ragged batch."""
    n = perm.shape[0]
    perm_h, assign_h = perm.tolist(), assign.tolist()

    def cell_at(p):  # PermChunk: cell 0 past n
        return perm_h[p] if p < n else 0

    ring = [None] * K_RING  # the cell whose row each slot holds
    for d in range(K_RING - 1):
        ring[d] = cell_at(d)
    st = ChainModel(sizes, log_denom)
    st.remove_first(assign_h[perm_h[0]])
    v = z[ring[0]]
    bpos, cb = n, 0
    for b in range(n_batches(n)):
        if bpos < n:  # once a batch
            break
        w = np.full((BATCH // 32, 32), np.nan, np.float32)
        for q in range(BATCH // 32):
            for j in range(min(32, n - cb)):
                i = cb + j
                ring[(i + K_RING - 1) % K_RING] = cell_at(i + K_RING - 1)
                v_n = z[ring[(i + 1) % K_RING]]
                assert ring[(i + 1) % K_RING] == cell_at(i + 1)
                last = q == BATCH // 32 - 1 and j == 31
                has_next = i + 1 < n and not (last and bpos < n)
                t, _, is_new = st.step(v, aux[perm_h[i]],
                                       assign_h[cell_at(i + 1)], has_next,
                                       last)
                w[q, j] = t
                if is_new:
                    bpos = min(bpos, i)
                v = v_n
            cb += 32
        base = b * BATCH
        if base + BATCH > n:
            _, idx = st.best_and_first(z[perm_h[n - 1]])
            inert = base + np.arange(BATCH).reshape(-1, 32) >= n
            w[inert] = idx
        assert not np.isnan(w).any()
        tgt[b] = _t(w.reshape(-1))
    sizes.copy_(st.sz)
    info.fill_(bpos)


def _run_vecflow(fn, z, aux, assign, perm, sizes, log_denom):
    n = perm.shape[0]
    tgt = torch.full((n_batches(n), BATCH), -7.0)
    t_sizes = _t(sizes).clone()
    info = torch.zeros((1,), dtype=torch.int32)
    fn(_t(z), _t(aux), _t(assign), _t(perm), t_sizes, tgt, info,
       torch.tensor(log_denom))
    return tgt, t_sizes, info



@pytest.mark.parametrize("name", list(vecflow_probe.CRAFTED))
def test_vecflow_model_equals_twin(name):
    *args, want = vecflow_probe.crafted_inputs(name)
    model = _run_vecflow(model_vecflow, *args)
    twin = _run_vecflow(vecflow_ref, *args)
    for x, y in zip(model, twin):
        assert torch.equal(x, y)
    assert int(model[2][0]) == want
    n = args[3].shape[0]
    rows = n_batches(n) if want == n else want // BATCH + 1
    assert (model[0][rows:] == -7.0).all()
    assert (model[0][:rows] != -7.0).all()


def test_vecflow_model_equals_pallas_birth_in_tail():
    z, aux, assign, perm, sizes, log_denom, want = vecflow_probe.crafted_inputs(
        "birth_in_tail")
    j_tgt, j_sizes, j_info = (np.asarray(x) for x in jvec.vecflow(
        jnp.asarray(z), jnp.asarray(aux), jnp.asarray(assign),
        jnp.asarray(perm), jnp.asarray(sizes)[None], float(log_denom),
        interpret=True))
    tgt, t_sizes, info = _run_vecflow(model_vecflow, z, aux, assign, perm,
                                      sizes, log_denom)
    assert int(info[0]) == int(j_info[0]) == want
    np.testing.assert_array_equal(tgt.numpy(), j_tgt)
    np.testing.assert_array_equal(t_sizes.numpy(), j_sizes[0])
