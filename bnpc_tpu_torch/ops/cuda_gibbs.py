"""The lazy Gibbs segment: CUDA kernel wrapper and its plain torch twin.

Counterpart of bnpc_tpu/ops/pallas_gibbs.py::pallas_lazy_segment. The kernel
(csrc/lazy_segment.cu) runs the per-cell loop of the sweep from position
``i0`` and exits at the first cluster birth; the caller
(models/gibbs.py::_segment_impl) patches the newborn's z column and relaunches.

Interface (both versions): ``sizes`` [k_pad] f32 (-1 on padded slots) is
updated in place, ``tgt`` [n] i32 receives the chosen slot of every visited
position in [i0, i_next), and ``info`` [4] i32 receives
(i_next, birth_cell, birth_slot, cap_veto); birth_cell == -1 when the
segment ran to the end, cap_veto == 1 iff some cell's new-cluster option
won while no slot was free.

The kernel bounds and verifies (csrc/lazy_segment.cu): a parallel pass
writes each position's best slot at the launch's sizes and a bound on every
other slot (``lazy_bounds_ref``) into the scratch ``bounds`` [3, n] f32,
and the walk settles a cell from that bound when a float32 check proves
the pick, running the full pick otherwise
(``lazy_segment_verified_ref``, which returns the number of full picks;
the kernel adds it to ``full`` [1] i32 when given). Both are plain models
of the kernel's arithmetic; ``lazy_segment_ref`` stays the definition and
is what the CPU runs.

``lazy_segment_chains`` runs a batch of chains' segments as one launch of
the same kernel on a grid of one block a chain: every argument gains a
leading chain axis, and ``i0s`` [C] i32 (a device tensor) holds each
chain's start position, advanced in place to its i_next, so that a
relaunch needs no host arguments; a chain with i0s[c] >= n writes only its
info row, (n, -1, -1, 0).

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.
"""

from __future__ import annotations

import numpy as np
import torch

from bnpc_tpu_torch.ops import _build

# Kernel launches since the last reset (each wrapper adds one per launch):
# one-chain launches, and batched launches with their count per grid size.
launches = 0
chain_launches = 0
chain_grids: dict[int, int] = {}

_SLOTS_PER_LANE = (1, 2, 4, 8, 16, 32)

# Slots of the streaming and eager kernels' shared-memory sizes row: the
# 227 KB of dynamic shared memory a block may use on sm_90, in floats.
SMEM_MAX_SLOTS = 232448 // 4


def lazy_k_pad(k_max: int) -> int:
    """Slot width the kernel runs at: 32 x a power of two >= k_max."""
    for spl in _SLOTS_PER_LANE:
        if 32 * spl >= k_max:
            return 32 * spl
    raise ValueError(f"k_max={k_max} exceeds the kernel's 1024 slots")


def stream_k_pad(k_max: int) -> int:
    """Slot width of the streaming and eager kernels: k_max rounded up to a
    multiple of 32, at most SMEM_MAX_SLOTS (their shared-memory sizes
    row)."""
    k_pad = -(-k_max // 32) * 32
    if k_pad > SMEM_MAX_SLOTS:
        raise ValueError(f"k_max={k_max} exceeds the {SMEM_MAX_SLOTS} slots "
                         "of the kernels' shared-memory sizes row")
    return k_pad


def resolve_stream(cfg) -> bool:
    """True when the sweep runs the streaming kernel: bnpc_tpu's rule
    (models/gibbs.py::resolve_stream, Z of 4 * round_up(n, 8) *
    round_up(k_max, 128) bytes over 13 MiB), or more slots than the
    resident kernel's 1024."""
    z_bytes = 4 * (-(-cfg.n_cells // 8) * 8) * (-(-cfg.k_max // 128) * 128)
    return z_bytes > 13 * 1024 * 1024 or cfg.k_max > 32 * _SLOTS_PER_LANE[-1]


def _log_w(sizes, log_denom):
    return torch.log(torch.clamp(sizes, min=0.0)) - log_denom


def pick_ref(z_row, sizes, aux, log_denom):
    """One cell's decision as the kernels take it, on `sizes` with the cell
    already removed. Returns host ints (cand, free, idx): cand whether the
    new-cluster option beats every slot, free the first free slot (k_pad
    when none), idx the first slot holding the best logit."""
    k_pad = sizes.shape[0]
    iota = torch.arange(k_pad, device=sizes.device)
    big = torch.full((), k_pad, device=sizes.device)
    logits = z_row + _log_w(sizes, log_denom)
    best = logits.max()
    free = torch.where(sizes == 0.0, iota, big).min()
    idx = torch.where(logits == best, iota, big).min()
    return torch.stack([(aux > best).long(), free, idx]).tolist()


def lazy_segment_ref(z, aux, assign, perm, sizes, tgt, info, i0: int,
                     log_denom):
    """Plain torch twin of the kernel: the same loop, the same float32
    expressions, the same first-index tie-breaks and early exit."""
    n, k_pad = perm.shape[0], z.shape[1]
    perm_h, assign_h = perm.tolist(), assign.tolist()
    veto, i_next, b_cell, b_slot = 0, n, -1, -1
    for i in range(i0, n):
        cell = perm_h[i]
        sizes[assign_h[cell]] -= 1.0
        cand, free, idx = pick_ref(z[cell], sizes, aux[cell], log_denom)
        is_new = bool(cand) and free < k_pad
        veto |= int(bool(cand) and free >= k_pad)
        t = free if is_new else idx
        sizes[t] += 1.0
        tgt[i] = t
        if is_new:
            i_next, b_cell, b_slot = i + 1, cell, t
            break
    info.copy_(torch.tensor([i_next, b_cell, b_slot, veto],
                            dtype=torch.int32))


# The settling tolerance's scale and floor (csrc/lazy_segment.cu derives
# them): tol = scale * (((|L| + D) + |s2|) + floor).
LAZY_TOL_SCALE = 2.0 ** -20
_TOL_FLOOR = np.float32(2.0 ** -100)


def lazy_bounds_ref(z, perm, sizes, i0: int, log_denom):
    """Plain model of the kernel's bound pass: [3, n] f32 whose column i
    >= i0 holds, for cell perm[i] and w0 the log weights of `sizes`, the
    first slot b holding max_k (z[cell, k] + w0[k]) (as a float), z[cell, b]
    and the max over k != b (-inf if none; a zero as +0.0, as the kernel's
    keys give it). Columns below i0 are 0."""
    n, k_pad = perm.shape[0], z.shape[1]
    out = torch.zeros((3, n), dtype=torch.float32, device=z.device)
    rows = z[perm[i0:].long()]
    logits = rows + _log_w(sizes, log_denom)
    best = logits.max(dim=1, keepdim=True).values
    iota = torch.arange(k_pad, device=z.device)
    b = torch.where(logits == best, iota, k_pad).min(dim=1).values
    rest = logits.scatter(1, b[:, None], float("-inf"))
    out[0, i0:] = b.to(torch.float32)
    out[1, i0:] = rows.gather(1, b[:, None])[:, 0]
    out[2, i0:] = rest.max(dim=1).values + 0.0
    return out


def lazy_segment_verified_ref(z, aux, assign, perm, sizes, tgt, info,
                              i0: int, log_denom,
                              tol_scale: float = LAZY_TOL_SCALE) -> int:
    """Plain model of the kernel's walk, on CPU tensors: lazy_segment_ref's
    interface and results, a cell settled from ``lazy_bounds_ref``'s bound
    when the kernel's float32 check proves its pick, ``pick_ref`` (the full
    pick) otherwise. D, the bound on how far any log weight rose since the
    launch, is raised at every removal and every gain. Returns the number
    of full picks."""
    n, k_pad = perm.shape[0], z.shape[1]
    perm_h, assign_h = perm.tolist(), assign.tolist()
    aux_h = aux.numpy()
    bnd = lazy_bounds_ref(z, perm, sizes, i0, log_denom).numpy()
    w0 = _log_w(sizes, log_denom).numpy()
    scale = np.float32(tol_scale)

    def weight(slot):  # the log weight of the slot's size as it stands
        return _log_w(sizes[slot:slot + 1], log_denom).numpy()[0]

    def move(slot, by, d_max):  # a size change; D raised by its new weight
        sizes[slot] += by
        return np.fmax(d_max, weight(slot) - w0[slot])

    veto, full, i_next, b_cell, b_slot = 0, 0, n, -1, -1
    d_max = np.float32(0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(i0, n):
            cell = perm_h[i]
            d_max = move(assign_h[cell], -1.0, d_max)
            b, vb, s2 = int(bnd[0, i]), bnd[1, i], bnd[2, i]
            big_l = vb + weight(b)
            abs_s2 = np.abs(s2) if s2 > -np.inf else np.float32(0.0)
            tol = scale * (((np.abs(big_l) + d_max) + abs_s2) + _TOL_FLOOR)
            t, is_new = b, False
            if not big_l > (s2 + d_max) + tol or aux_h[cell] > big_l:
                full += 1
                cand, free, idx = pick_ref(z[cell], sizes, aux[cell],
                                           log_denom)
                is_new = bool(cand) and free < k_pad
                veto |= int(bool(cand) and free >= k_pad)
                t = free if is_new else idx
            d_max = move(t, 1.0, d_max)
            tgt[i] = t
            if is_new:
                i_next, b_cell, b_slot = i + 1, cell, t
                break
    info.copy_(torch.tensor([i_next, b_cell, b_slot, veto],
                            dtype=torch.int32))
    return full


def _scratch(bounds, full, lead, n, dev):
    """The kernel's bounds scratch ([*lead, 3, n] f32, made when None) and
    the pointer of `full` (0 when None), both checked."""
    if bounds is None:
        bounds = torch.empty((*lead, 3, n), dtype=torch.float32, device=dev)
    _build.check_tensor(bounds, "bounds", torch.float32, (*lead, 3, n), dev)
    if full is None:
        return bounds, 0
    _build.check_tensor(full, "full", torch.int32, lead or (1,), dev)
    return bounds, full.data_ptr()


def lazy_segment(z, aux, assign, perm, sizes, tgt, info, i0: int, log_denom,
                 bounds=None, full=None):
    """Run one birth-bounded segment (see the module docstring).

    z [n, k_pad] f32; aux [n] f32; assign, perm [n] i32; sizes [k_pad] f32;
    tgt [n] i32; info [4] i32; log_denom 0-d f32 tensor; i0 a host int;
    on CUDA, bounds [3, n] f32 scratch (made when None) and full [1] i32
    (or None), which gains the launch's number of full picks.
    """
    if z.device.type == "cpu":
        return lazy_segment_ref(z, aux, assign, perm, sizes, tgt, info, i0,
                                log_denom)
    if z.device.type != "cuda":
        raise ValueError(f"lazy_segment: unsupported device {z.device}")
    n, k_pad = perm.shape[0], z.shape[1]
    if k_pad not in tuple(32 * s for s in _SLOTS_PER_LANE):
        raise ValueError(f"lazy_segment: k_pad={k_pad} unsupported")
    if not 0 <= i0 <= n:
        raise ValueError(f"lazy_segment: i0={i0} outside [0, {n}]")
    dev = z.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(z, "z", f32, (n, k_pad), dev)
    _build.check_tensor(aux, "aux", f32, (n,), dev)
    _build.check_tensor(assign, "assign", i32, (n,), dev)
    _build.check_tensor(perm, "perm", i32, (n,), dev)
    _build.check_tensor(sizes, "sizes", f32, (k_pad,), dev)
    _build.check_tensor(tgt, "tgt", i32, (n,), dev)
    _build.check_tensor(info, "info", i32, (4,), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (), dev)
    bounds, full_p = _scratch(bounds, full, (), n, dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_lazy_segment(
        z.data_ptr(), aux.data_ptr(), assign.data_ptr(), perm.data_ptr(),
        sizes.data_ptr(), tgt.data_ptr(), info.data_ptr(),
        log_denom.data_ptr(), bounds.data_ptr(), full_p, n, k_pad, int(i0),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_lazy_segment")


def segment_chains_ref(segment_ref, args, sizes, tgt, info, i0s, log_denom):
    """A batched twin: the one-chain twin `segment_ref` on chain c's slices
    (``args`` its [C, ...] inputs before the outputs), for every chain whose
    start position is below n; the others get the info row (n, -1, -1, 0).
    i0s advances to each chain's i_next."""
    n = tgt.shape[1]
    for c, i0 in enumerate(i0s.tolist()):
        if i0 >= n:
            info[c] = torch.tensor([n, -1, -1, 0], dtype=torch.int32)
            continue
        segment_ref(*(a[c] for a in args), sizes[c], tgt[c], info[c], i0,
                    log_denom[c])
        i0s[c] = info[c, 0]


def lazy_segment_chains_ref(z, aux, assign, perm, sizes, tgt, info, i0s,
                            log_denom):
    """Plain torch twin of the batched launch: lazy_segment_ref chain by
    chain."""
    segment_chains_ref(lazy_segment_ref, (z, aux, assign, perm), sizes, tgt,
                       info, i0s, log_denom)


def lazy_segment_chains(z, aux, assign, perm, sizes, tgt, info, i0s,
                        log_denom, bounds=None, full=None):
    """One batched segment launch (see the module docstring).

    z [C, n, k_pad] f32; aux [C, n] f32; assign, perm [C, n] i32; sizes
    [C, k_pad] f32; tgt [C, n] i32; info [C, 4] i32; i0s [C] i32;
    log_denom [C] f32; on CUDA, bounds [C, 3, n] f32 scratch (made when
    None) and full [C] i32 (or None), which gains each chain's number of
    full picks.
    """
    if z.device.type == "cpu":
        return lazy_segment_chains_ref(z, aux, assign, perm, sizes, tgt,
                                       info, i0s, log_denom)
    if z.device.type != "cuda":
        raise ValueError(f"lazy_segment_chains: unsupported device "
                         f"{z.device}")
    c, n, k_pad = z.shape
    if k_pad not in tuple(32 * s for s in _SLOTS_PER_LANE):
        raise ValueError(f"lazy_segment_chains: k_pad={k_pad} unsupported")
    dev = z.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(z, "z", f32, (c, n, k_pad), dev)
    _build.check_tensor(aux, "aux", f32, (c, n), dev)
    _build.check_tensor(assign, "assign", i32, (c, n), dev)
    _build.check_tensor(perm, "perm", i32, (c, n), dev)
    _build.check_tensor(sizes, "sizes", f32, (c, k_pad), dev)
    _build.check_tensor(tgt, "tgt", i32, (c, n), dev)
    _build.check_tensor(info, "info", i32, (c, 4), dev)
    _build.check_tensor(i0s, "i0s", i32, (c,), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (c,), dev)
    bounds, full_p = _scratch(bounds, full, (c,), n, dev)
    lib = _build.load_library()
    global chain_launches
    chain_launches += 1
    chain_grids[c] = chain_grids.get(c, 0) + 1
    rc = lib.bnpc_lazy_segment_chains(
        z.data_ptr(), aux.data_ptr(), assign.data_ptr(), perm.data_ptr(),
        sizes.data_ptr(), tgt.data_ptr(), info.data_ptr(),
        log_denom.data_ptr(), i0s.data_ptr(), bounds.data_ptr(), full_p, c,
        n, k_pad, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_lazy_segment_chains")
