"""The arithmetic of the Gibbs kernels' per-cell step, modelled on the CPU.

The CUDA step (bnpc_tpu_torch/csrc/gibbs_common.cuh::chain_step) does not
recompute the log weights of every slot for every cell. It carries, beside
the sizes row,

    w[s]  = log(max(size[s], 0)) - log_denom       (the slot's log weight)
    wp[s] = log(max(size[s] + 1, 0)) - log_denom   (its weight after a +1)

and between two cells changes them only at the slot that gained the cell
and the slot that loses the next one; the two logs it needs are started
before the pick they follow is known. The best logit crosses the warp as an
order-preserving unsigned key (one integer reduction), the first index as
a second. This file holds a
plain model of exactly that step (`ChainModel`) and checks, cell by cell,
that it equals the plain twins `pick_ref` / `lazy_segment_ref`, which are
the kernels' definition, and that the key map is monotone with float
equality. The model mirrors the kernel's order of updates line by line.
"""

import numpy as np
import pytest
import torch

from bnpc_tpu_torch.ops.cuda_gibbs import lazy_segment_ref, pick_ref
from bnpc_tpu_torch.probes import chain_probe

torch.set_num_threads(1)

F32 = torch.float32


# ---------------------------------------------------------------------------
# The key map
# ---------------------------------------------------------------------------


def key_of(x: np.ndarray) -> np.ndarray:
    """float32 -> uint32, order preserving: (x + 0.0f) makes -0.0 into +0.0,
    then a positive float gets its sign bit set and a negative one is
    inverted."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    sign = (u.view(np.int32) >> 31).view(np.uint32)  # 0 or 0xffffffff
    return u ^ (sign | np.uint32(0x80000000))


def float_of_key(key: np.ndarray) -> np.ndarray:
    key = np.asarray(key, np.uint32)
    sign = (key.view(np.int32) >> 31).view(np.uint32)
    return (key ^ (~sign | np.uint32(0x80000000))).view(np.float32)


def _key_values():
    rng = np.random.default_rng(0)
    tiny = np.float32(1e-45)  # the smallest denormal
    special = np.array([-np.inf, -3.4e38, -1e30, -1.0, -1e-38, -tiny, -0.0,
                        0.0, tiny, 1e-38, 1.0, 1e30, 3.4e38, np.inf],
                       np.float32)
    rand = rng.standard_normal(4000).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-40, 38, 4000).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    bits = bits.view(np.float32)
    with np.errstate(over="ignore"):
        return np.concatenate([special, rand, bits[~np.isnan(bits)]])


def test_key_map_is_monotone():
    x = np.sort(_key_values())
    k = key_of(x).astype(np.int64)
    assert (np.diff(k) >= 0).all()
    # Strictly increasing wherever the floats are.
    assert ((np.diff(k) > 0) == (np.diff(x) > 0)).all()


def test_key_equality_is_float_equality():
    x = _key_values()[:1500]
    a, b = np.meshgrid(x, x)
    assert ((key_of(a) == key_of(b)) == (a == b)).all()
    assert ((key_of(a) > key_of(b)) == (a > b)).all()


def test_key_zeros_and_infinities():
    assert key_of(np.float32(-0.0)) == key_of(np.float32(0.0))
    assert key_of(np.float32(-np.inf)) == np.uint32(0x007FFFFF)
    # Nothing that is not a NaN lies below -inf: 0 can seed a running max.
    assert key_of(_key_values()).min() == key_of(np.float32(-np.inf))


def test_key_round_trip():
    x = _key_values()
    back = float_of_key(key_of(x))
    np.testing.assert_array_equal(back, x + np.float32(0.0))
    assert not np.signbit(float_of_key(key_of(np.float32(-0.0))))


# ---------------------------------------------------------------------------
# The model of the step
# ---------------------------------------------------------------------------


def _log_w(size: torch.Tensor, log_denom) -> torch.Tensor:
    return torch.log(torch.clamp(size, min=0.0)) - log_denom


class ChainModel:
    """The carried state of csrc/gibbs_common.cuh::Chain and its step, one
    element per slot instead of one per lane and register."""

    def __init__(self, sizes: torch.Tensor, log_denom: torch.Tensor):
        self.ld = log_denom
        self.sz = sizes.clone()
        self.w = _log_w(self.sz, self.ld)
        self.wp = _log_w(self.sz + 1.0, self.ld)
        self.pend = -1  # slot whose wp is stale
        self.logs = 2 * sizes.shape[0]  # log evaluations so far

    def remove_first(self, old: int):
        """The first cell's removal, before any step."""
        self.sz[old] -= 1.0
        self.wp[old] = self.w[old]
        self.w[old] = _log_w(self.sz[old:old + 1], self.ld)[0]
        self.logs += 1

    def best_and_first(self, v):
        """Best logit and the first slot holding it, as the warp takes
        them: a float max within each lane (slots l, l + 32, ...), the
        lanes' maxima across the warp as keys, a float == per slot."""
        logit = (v + self.w).numpy()
        lane_max = np.max(logit.reshape(-1, 32), axis=0)
        best = float_of_key(key_of(lane_max).max())
        return best, int(np.flatnonzero(logit == best)[0])

    def step(self, v, a, old_next: int, has_next: bool, stop_at_birth: bool):
        """One cell whose removal is already in the state. Returns
        (t, cand, is_new); applies +1 at t and, unless the segment ends
        here, -1 at `old_next`."""
        k = self.sz.shape[0]
        # Started before the pick is known: both read the state at entry.
        wp_fix = wm = None
        if self.pend >= 0:
            p = self.pend
            wp_fix = _log_w(self.sz[p:p + 1] + 1.0, self.ld)[0]
            self.logs += 1
        if has_next:
            o = old_next
            wm = _log_w(self.sz[o:o + 1] - 1.0, self.ld)[0]
            self.logs += 1

        best, idx = self.best_and_first(v)
        cand = bool(np.float32(a) > best)
        is_new, t = False, idx
        if cand:  # only now is the first free slot needed
            zero = np.flatnonzero(self.sz.numpy() == 0.0)
            free = int(zero[0]) if zero.size else k
            is_new = free < k
            if is_new:
                t = free

        if self.pend >= 0:
            self.wp[self.pend] = wp_fix
        remove = has_next and not (stop_at_birth and is_new)
        if not (remove and t == old_next):  # else +1 and -1 cancel
            self.sz[t] += 1.0
            self.w[t] = self.wp[t]
            if remove:
                o = old_next
                self.sz[o] -= 1.0
                self.wp[o] = self.w[o]
                self.w[o] = wm
        self.pend = t
        return t, cand, is_new


def model_segment(z, aux, assign, perm, sizes, tgt, info, i0, log_denom):
    """lazy_segment_ref's interface on ChainModel."""
    n = perm.shape[0]
    perm_h, assign_h = perm.tolist(), assign.tolist()
    veto, i_next, b_cell, b_slot = 0, n, -1, -1
    st = ChainModel(sizes, log_denom)
    if i0 < n:
        st.remove_first(assign_h[perm_h[i0]])
    for i in range(i0, n):
        cell = perm_h[i]
        has_next = i + 1 < n
        old_next = assign_h[perm_h[i + 1]] if has_next else 0
        t, cand, is_new = st.step(z[cell], aux[cell], old_next, has_next,
                                  stop_at_birth=True)
        veto |= int(cand and not is_new)
        tgt[i] = t
        if is_new:
            i_next, b_cell, b_slot = i + 1, cell, t
            break
    sizes.copy_(st.sz)
    info.copy_(torch.tensor([i_next, b_cell, b_slot, veto],
                            dtype=torch.int32))
    return st


def _run_both(z, aux, assign, perm, sizes, log_denom, i0=0):
    """Both versions over the whole sweep, relaunched after every birth as
    the lazy driver does (without its z patch). Returns the model's and the
    twin's (tgt, sizes, infos)."""
    n = perm.shape[0]
    out = []
    for fn in (model_segment, lazy_segment_ref):
        sz = sizes.clone()
        tgt = torch.full((n,), -7, dtype=torch.int32)
        infos, i = [], i0
        while True:
            info = torch.zeros((4,), dtype=torch.int32)
            fn(z, aux, assign, perm, sz, tgt, info, i, log_denom)
            infos.append(info.tolist())
            i = infos[-1][0]
            if i >= n:
                break
        out.append((tgt, sz, infos))
    return out


def _assert_same(model, twin):
    (mt, ms, mi), (rt, rs, ri) = model, twin
    assert mi == ri
    assert torch.equal(mt, rt)
    assert torch.equal(ms, rs)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_case(seed, n, k_pad, k_max, live, hot_frac, scale=3.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, k_pad)) * scale).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    assign = rng.integers(0, live, n).astype(np.int32)
    aux = np.full(n, -1e30, np.float32)
    aux[rng.random(n) < hot_frac] = 1e30
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    log_denom = torch.tensor(np.log(n - 1.0 + 3.0), dtype=F32)
    return _t(z), _t(aux), _t(assign), _t(perm), _t(sizes), log_denom


@pytest.mark.parametrize("seed", range(6))
def test_model_equals_twin_random_segments(seed):
    """Births (10% of cells hot), deaths to 0 (more slots than cells per
    slot), and once the free slots run out, vetoes."""
    n, k_pad, k_max = 96, 64, 40
    z, aux, assign, perm, sizes, ld = _random_case(seed, n, k_pad, k_max,
                                                   live=30, hot_frac=0.1)
    model, twin = _run_both(z, aux, assign, perm, sizes, ld, i0=seed)
    _assert_same(model, twin)
    infos = twin[2]
    assert len(infos) > 1, "no birth exercised"
    if seed % 2:
        return
    # A second sweep from the result on other rows: the live clusters are
    # small, so many die and are born into again.
    i0 = seed
    assign2 = assign.clone()
    assign2[perm[i0:].long()] = twin[0][i0:]
    model, twin = _run_both(z.flip(0).contiguous(), aux, assign2, perm,
                            twin[1], ld)
    _assert_same(model, twin)


def test_model_equals_twin_vetoes():
    n, k_pad, k_max = 80, 32, 16
    rng = np.random.default_rng(7)
    z = (rng.standard_normal((n, k_pad)) * 3.0).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    assign = (np.arange(n) % k_max).astype(np.int32)  # every slot live
    aux = np.full(n, -1e30, np.float32)
    aux[perm[[0, 1, 40, 79]]] = 1e30
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    ld = torch.tensor(np.log(n + 2.0), dtype=F32)
    model, twin = _run_both(_t(z), _t(aux), _t(assign), _t(perm), _t(sizes),
                            ld)
    _assert_same(model, twin)
    assert twin[2] == [[n, -1, -1, 1]]


def _tie_case(kind):
    """Eight cells over k_pad 64 (slots 0-47 real). Cell 3's row makes two
    slots tie for the best logit."""
    n, k_pad, k_max = 8, 64, 48
    z = np.full((n, k_pad), -50.0, np.float32)
    z[:, 0] = 0.0  # every other cell goes to slot 0
    assign = np.zeros(n, np.int32)
    sizes = np.full(k_pad, 1.0, np.float32)  # weights log(1) = 0
    sizes[0] = n + 1.0
    sizes[k_max:] = -1.0
    log_denom = 0.0
    a, b = {"lanes": (7, 3), "one_lane": (35, 3), "zeros": (37, 5),
            "masked": (40, 9)}[kind]
    z[3, 0] = -50.0
    if kind == "zeros":
        # log_denom 0 and size 1: the logits are the row's own +0.0 and
        # -0.0, equal as floats; every other slot is below.
        z[3, a], z[3, b] = 0.0, -0.0
    elif kind == "masked":
        # The whole row at one value: every real slot of size 1 ties, and
        # the masked slots (size -1, logit -inf) must lose.
        z[3, 1:] = 2.5
        sizes[1:5] = 0.0  # free slots have logit -inf too
        a, b = 5, 6
    else:
        z[3, a] = z[3, b] = 1.25
    first = min(a, b)
    aux = np.full(n, -1e30, np.float32)
    perm = np.arange(n, dtype=np.int32)
    return (_t(z), _t(aux), _t(assign), _t(perm), _t(sizes),
            torch.tensor(log_denom, dtype=F32)), first


@pytest.mark.parametrize("kind", ["lanes", "one_lane", "zeros", "masked"])
def test_model_equals_twin_ties(kind):
    """The first index wins a tie: between slots of two lanes (3 and 7),
    of one lane (3 and 35), between -0.0 and +0.0, and against masked and
    free slots."""
    args, first = _tie_case(kind)
    model, twin = _run_both(*args)
    _assert_same(model, twin)
    assert int(twin[0][3]) == first


@pytest.mark.parametrize("aux3", [-np.inf, 1e30])
def test_model_equals_twin_all_minus_inf(aux3):
    """A row of -inf: every logit is -inf and slot 0 is the first to hold
    the best. With a winning new-cluster option the free slot is taken."""
    n, k_pad, k_max = 6, 32, 20
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((n, k_pad)) * 2.0).astype(np.float32)
    z[3, :] = -np.inf
    assign = rng.integers(0, 4, n).astype(np.int32)
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    aux = np.full(n, -np.inf, np.float32)
    aux[3] = aux3
    perm = np.arange(n, dtype=np.int32)
    ld = torch.tensor(1.5, dtype=F32)
    model, twin = _run_both(_t(z), _t(aux), _t(assign), _t(perm), _t(sizes),
                            ld)
    _assert_same(model, twin)
    first_free = int(np.flatnonzero(sizes == 0.0)[0])
    assert int(twin[0][3]) == (0 if aux3 < 0 else first_free)


def test_model_equals_twin_death_then_birth_into_lower_slot():
    """Slot 2 holds one cell, which leaves (a death to size 0); a later
    birth must take slot 2, below the free slots 6-19."""
    n, k_pad, k_max = 12, 32, 20
    z = np.full((n, k_pad), -30.0, np.float32)
    z[:, 0] = 0.0
    assign = np.array([0, 1, 2, 3, 4, 5] + [0] * 6, np.int32)
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    aux = np.full(n, -1e30, np.float32)
    aux[7] = 1e30
    perm = np.arange(n, dtype=np.int32)
    ld = torch.tensor(np.log(n + 1.0), dtype=F32)
    model, twin = _run_both(_t(z), _t(aux), _t(assign), _t(perm), _t(sizes),
                            ld)
    _assert_same(model, twin)
    # Slots 1-5 died at cells 1-5; the birth takes the lowest, slot 1.
    assert twin[2][0] == [8, 7, 1, 0]


def test_model_same_slot_twice_and_take_back():
    """The cases the cached rows must survive: one slot picked by
    consecutive cells (wp stale when it is needed again), and a cell that
    joins the slot the next cell leaves (+1 and -1 cancel)."""
    n, k_pad, k_max = 10, 32, 8
    z = np.full((n, k_pad), -30.0, np.float32)
    z[:, 5] = 4.0  # every cell picks slot 5
    assign = np.array([0, 1, 5, 5, 2, 5, 3, 5, 5, 4], np.int32)
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    sizes[k_max:] = -1.0
    aux = np.full(n, -1e30, np.float32)
    perm = np.arange(n, dtype=np.int32)
    ld = torch.tensor(0.75, dtype=F32)
    model, twin = _run_both(_t(z), _t(aux), _t(assign), _t(perm), _t(sizes),
                            ld)
    _assert_same(model, twin)
    assert twin[0].tolist() == [5] * n


def test_model_counts_two_logs_a_cell():
    """What the cache is for: 2 * k_pad logs at entry, one for the first
    removal, then at most two a cell, against k_pad a cell."""
    n, k_pad = 64, 128
    z, aux, assign, perm, sizes, ld = _random_case(11, n, k_pad, 100,
                                                   live=20, hot_frac=0.0)
    tgt = torch.empty((n,), dtype=torch.int32)
    info = torch.empty((4,), dtype=torch.int32)
    st = model_segment(z, aux, assign, perm, sizes, tgt, info, 0, ld)
    assert info.tolist()[0] == n
    assert st.logs <= 2 * k_pad + 1 + 2 * n
    assert st.logs < n * k_pad // 8


@pytest.mark.parametrize("seed", range(3))
def test_model_runs_on_past_a_birth(seed):
    """The eager sweep and the vecflow probe do not stop at a birth: the
    step then takes the next cell's removal too. Against a loop over
    pick_ref."""
    n, k_pad, k_max = 64, 64, 40
    z, aux, assign, perm, sizes, ld = _random_case(20 + seed, n, k_pad,
                                                   k_max, live=12,
                                                   hot_frac=0.2)
    perm_h, assign_h = perm.tolist(), assign.tolist()
    want, sz = [], sizes.clone()
    for i in range(n):
        cell = perm_h[i]
        sz[assign_h[cell]] -= 1.0
        cand, free, idx = pick_ref(z[cell], sz, aux[cell], ld)
        t = free if cand and free < k_pad else idx
        sz[t] += 1.0
        want.append(t)

    st = ChainModel(sizes, ld)
    st.remove_first(assign_h[perm_h[0]])
    got, births = [], 0
    for i in range(n):
        has_next = i + 1 < n
        old_next = assign_h[perm_h[i + 1]] if has_next else 0
        t, _, is_new = st.step(z[perm_h[i]], aux[perm_h[i]], old_next,
                               has_next, stop_at_birth=False)
        births += is_new
        got.append(t)
    assert got == want
    assert torch.equal(st.sz, sz)
    assert births > 1


# ---------------------------------------------------------------------------
# The chain bound (probes/chain_probe.py)
# ---------------------------------------------------------------------------


def test_chain_bound_arithmetic():
    cycles = {"shfl_fmax": 30.0, "redux_max": 20.0, "logf": 90.0,
              "smem_load_use": 25.0, "cmp_select": 8.0, "fadd": 4.0,
              "iadd": 4.0, "icmp_select": 8.0, "scan_link": 9.0}
    per_cell = chain_probe.argmax_chain_cycles(cycles)
    # select, add, two reductions, select
    assert per_cell == 2 * 20.0 + 4.0 + 2 * 8.0
    # The scan as written: load-use, add, compare + select, integer add;
    # with thresholds known ahead: the measured integer link.
    assert chain_probe.table_scan_chain_cycles(cycles) \
        == 25.0 + 4.0 + 8.0 + 4.0
    assert chain_probe.scan_chain_cycles(cycles) == 9.0
    ms = chain_probe.chain_bound_ms(5000, per_cell, clock_ghz=2.0)
    assert ms == pytest.approx(5000 * 60.0 / 2.0e9 * 1e3)


def test_chain_probe_needs_a_card():
    with pytest.raises(SystemExit):
        chain_probe.main(["--device", "cpu"])
