"""Probe: the lazy segment's early exit and relaunch.

Counterpart of benchmarks/mosaic_while_probe.py (its inline Pallas kernel).
The kernel (csrc/while_probe.cu) runs, from position ``i0``, a loop over
positions that ends after the first "birth", with the TPU probe's
arithmetic:

    cell = perm[i]; v = z[cell]; logits = v + log(max(sizes, 0))
    best = max(logits); idx = argmax(logits); cand = v[0] > best
    t = first free slot if cand and one exists, else idx
    out[i] = t; sizes += onehot(t)

NaN propagates as in JAX (the TPU probe starts from an output it never
wrote, NaN in interpret mode): a NaN logit is the max, and idx is the first
NaN slot. The kernel runs lazy_segment's loop (a cp.async row ring, perm a
chunk ahead, one basic block) and its step's devices (log weights cached
beside the sizes, best and first index as two integer warp reductions, the
free slot only when v[0] wins), with a key map that sends every NaN above
+inf. ``sizes`` [k_pad] f32 is the explicit initial row, updated in
place; ``out`` [n] i32 receives the targets of positions [i0, info[0]);
``info`` [4] i32 receives (i_next, birth_cell, -1, -1), birth_cell -1 when
the loop ran to n.

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.

    python -m bnpc_tpu_torch.probes.while_probe

runs the TPU probe's input (seed 0, NaN sizes, i0 0) and prints info; on
the card it then times (a) a full no-birth run from i0 = 0 on finite sizes,
beside lazy_segment on the same z and perm, and (b) one relaunch at
i0 = n - 1: by CUDA events around the call, and by host clock until the
call returns and until ``info.tolist()`` returns, the lazy driver's fixed
cost per birth (models/gibbs.py::_segment_impl).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_gibbs import _SLOTS_PER_LANE, lazy_segment
from bnpc_tpu_torch.probes import card, cuda_ms, parse_args

N, K_PAD = 512, 256
RELAUNCH_REPS = 101

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def while_exit_ref(z, perm, sizes, out, info, i0: int):
    """Plain torch twin of the kernel: the same loop and float32
    expressions, JAX's NaN rules, the same early exit."""
    n, k_pad = perm.shape[0], z.shape[1]
    iota = torch.arange(k_pad, device=z.device)
    big = torch.full((), k_pad, device=z.device)
    perm_h = perm.tolist()
    i_next, b_cell = n, -1
    for i in range(i0, n):
        cell = perm_h[i]
        v = z[cell]
        logits = v + torch.log(torch.clamp(sizes, min=0.0))
        best = logits.max()
        hit = torch.where(torch.isnan(best), torch.isnan(logits),
                          logits == best)
        idx = torch.where(hit, iota, big).min()
        free = torch.where(sizes == 0.0, iota, big).min()
        cand, free, idx = torch.stack([(v[0] > best).long(), free,
                                       idx]).tolist()
        is_new = bool(cand) and free < k_pad
        t = free if is_new else idx
        sizes += (iota == t).to(sizes.dtype)
        out[i] = t
        if is_new:
            i_next, b_cell = i + 1, cell
            break
    info.copy_(torch.tensor([i_next, b_cell, -1, -1], dtype=torch.int32))


def while_exit(z, perm, sizes, out, info, i0: int):
    """Run the probe's loop from `i0` (see the module docstring).

    z [n, k_pad] f32; perm [n] i32; sizes [k_pad] f32; out [n] i32;
    info [4] i32; i0 a host int.
    """
    if z.device.type == "cpu":
        return while_exit_ref(z, perm, sizes, out, info, i0)
    if z.device.type != "cuda":
        raise ValueError(f"while_exit: unsupported device {z.device}")
    n, k_pad = perm.shape[0], z.shape[1]
    if k_pad not in tuple(32 * s for s in _SLOTS_PER_LANE):
        raise ValueError(f"while_exit: k_pad={k_pad} unsupported")
    if not 0 <= i0 <= n:
        raise ValueError(f"while_exit: i0={i0} outside [0, {n}]")
    dev = z.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(z, "z", f32, (n, k_pad), dev)
    _build.check_tensor(perm, "perm", i32, (n,), dev)
    _build.check_tensor(sizes, "sizes", f32, (k_pad,), dev)
    _build.check_tensor(out, "out", i32, (n,), dev)
    _build.check_tensor(info, "info", i32, (4,), dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_while_exit(
        z.data_ptr(), perm.data_ptr(), sizes.data_ptr(), out.data_ptr(),
        info.data_ptr(), n, k_pad, int(i0),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_while_exit")


def make_inputs(n, k_pad, device, seed=0):
    """The TPU probe's z and perm, with finite sizes for a no-birth run:
    12 live clusters (slot 0 holds cells, so v[0] never beats the best
    logit), -1 beyond. Returns (z, perm, finite sizes)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, k_pad)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    sizes = np.full(k_pad, -1.0, np.float32)
    sizes[:12] = np.bincount(np.arange(n) % 12, minlength=12)
    return tuple(torch.from_numpy(x).to(device) for x in (z, perm, sizes))


# NaNs of both signs and several payloads.
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFBFFFFF, 0x7FFFFFFF,
                 0xFFFFFFFF], np.uint32).view(np.float32)

# Crafted inputs on which the kernel must equal the twin (crafted_inputs).
CRAFTED = ("tpu_nan_start", "nan_slot0", "nan_later_slot",
           "nan_signs_payloads", "signed_zero_ties", "all_minus_inf",
           "sizes_minus_one", "birth_at_i0", "birth_at_last", "random")


def crafted_inputs(name, n=64, k_pad=64):
    """One crafted case as numpy arrays: (z, perm, sizes, i0, info[:2] it
    must give, or None). n >= 40, k_pad >= 32. Where a birth is wanted,
    slot 0 is empty or masked and z[:, 0] is -5 elsewhere, so that v[0]
    wins only there."""
    rng = np.random.default_rng(100 + len(name))
    z = rng.normal(size=(n, k_pad)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    sizes = np.full(k_pad, -1.0, np.float32)
    sizes[:12] = rng.integers(1, 30, 12)
    k, i0, want = k_pad, 0, None
    if name == "tpu_nan_start":  # the TPU probe's start: NaN sizes
        sizes[:] = np.nan
        want = [n, -1]
    elif name == "nan_slot0":
        sizes[0] = np.nan
    elif name == "nan_later_slot":
        sizes[k - 27] = np.nan
    elif name == "nan_signs_payloads":
        # NaN logits from z, of both signs and several payloads, at slots
        # of different lanes and rows; a NaN v[0] (no birth); then a birth.
        sizes[0] = -1.0
        sizes[[5, 40 % k]] = 0.0
        z[:, 0] = -5.0
        for j, cell in enumerate(perm[3:40:4]):
            z[cell, [7 + j, (33 + 3 * j) % k][j % 2]] = NANS[j % len(NANS)]
            z[cell, (2 * j + 50) % k] = NANS[(j + 3) % len(NANS)]
        z[perm[10], 0] = NANS[1]
        z[perm[12], 0] = 100.0
        want = [13, int(perm[12])]
    elif name == "signed_zero_ties":
        # v -0.0 and +0.0 on slots of size 1 (logits +0.0 either way, a
        # tie the first slot wins), v[0] -0.0 against a best of +0.0 (no
        # birth), and -0.0 sizes, free, that the twin turns into +0.0.
        sizes[:] = -1.0
        sizes[[3, 9, 40 % k]] = 1.0
        sizes[[20, 21]] = -0.0
        z[:] = -1e30
        z[:, [3, 40 % k]] = -0.0
        z[:, 9] = 0.0
        z[:, 0] = -0.0
        want = [n, -1]
    elif name == "all_minus_inf":
        z[:] = -np.inf
        want = [n, -1]
    elif name == "sizes_minus_one":
        sizes[:] = -1.0
        sizes[[1, 4]] = 2.0
        z[:, 0] = -5.0
        z[perm[6], k - 1] = np.inf  # +inf + log(0): a NaN logit
        want = [n, -1]
    elif name == "birth_at_i0":
        i0 = 5
        sizes[0] = 0.0
        z[:, 0] = -5.0
        z[perm[i0], 0] = 50.0
        want = [i0 + 1, int(perm[i0])]
    elif name == "birth_at_last":
        i0 = 17
        sizes[0] = 0.0
        z[:, 0] = -5.0
        z[perm[n - 1], 0] = 50.0
        want = [n, int(perm[n - 1])]
    elif name == "random":  # NaNs in z, free and masked slots, a birth
        sizes[rng.random(k) < 0.2] = 0.0
        sizes[0] = -1.0
        z[:, 0] = -5.0
        z[rng.random((n, k)) < 0.002] = NANS[3]
        i0 = int(rng.integers(0, n // 2))
        z[perm[i0 + n // 4], 0] = 30.0  # unless its row holds a NaN
    else:
        raise KeyError(name)
    return z, perm, sizes, i0, want


def main(argv=None) -> dict:
    args = parse_args(argv, "early-exit probe")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("while_probe: no CUDA device (--device cpu runs "
                         "the plain twin)")
    n, k_pad = N, K_PAD
    z, perm, sizes_fin = make_inputs(n, k_pad, dev)
    out = torch.full((n,), -7, dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    sizes = torch.full((k_pad,), float("nan"), device=dev)
    while_exit(z, perm, sizes, out, info, 0)
    print(f"while_probe (n={n}, k_pad={k_pad}, {dev}): NaN sizes from i0 "
          f"0; info: {info.tolist()}", flush=True)
    res = {"n": n, "k_pad": k_pad, "info": info.tolist()}
    if dev.type != "cuda":
        print("timing needs a CUDA device; none taken")
        return res

    smi = card()
    reps = 31
    buf = iter([sizes_fin.clone() for _ in range(reps + 1)])
    while_exit(z, perm, next(buf), out, info, 0)
    if info.tolist()[:2] != [n, -1]:
        raise AssertionError(f"while_exit: a birth in the no-birth run: "
                             f"{info.tolist()}")
    res["full_ms"] = cuda_ms(lambda: while_exit(z, perm, next(buf), out,
                                                info, 0), reps)
    # lazy_segment on the same z and perm, the same sizes (12 live
    # clusters) and no birth (aux -inf): the shipped chain at this shape.
    assign = (torch.arange(n, device=dev) % 12).to(torch.int32)
    aux = torch.full((n,), -float("inf"), device=dev)
    log_denom = torch.zeros((), device=dev)
    tgt = torch.empty((n,), dtype=torch.int32, device=dev)
    info_l = torch.empty((4,), dtype=torch.int32, device=dev)
    buf = iter([sizes_fin.clone() for _ in range(reps)])
    res["lazy_segment_ms"] = cuda_ms(lambda: lazy_segment(
        z, aux, assign, perm, next(buf), tgt, info_l, 0, log_denom), reps)
    for name in ("full", "lazy_segment"):
        ms = res[f"{name}_ms"]
        print(f"(a) {'while_exit' if name == 'full' else name} full no-birth "
              f"run from i0 0: {ms:.4f} ms ({ms / n * 1e3:.4f} us/cell; "
              f"median of {reps}, CUDA events; {smi})", flush=True)

    def relaunch():
        while_exit(z, perm, sizes_fin, out, info, n - 1)

    relaunch()
    # Events around one call on an idle stream: the wrapper's host time,
    # the launch and the one-cell kernel.
    res["relaunch_ms"] = cuda_ms(relaunch, RELAUNCH_REPS)
    enqueue, read = [], []
    for _ in range(RELAUNCH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        relaunch()
        t1 = time.perf_counter()
        info.tolist()
        read.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    res["relaunch_enqueue_ms"] = float(np.median(enqueue))
    res["relaunch_read_ms"] = float(np.median(read))
    print(f"(b) relaunch at i0 {n - 1}: {res['relaunch_ms']:.4f} ms by CUDA "
          f"events around the call; by host clock, the call returns after "
          f"{res['relaunch_enqueue_ms']:.4f} ms and info.tolist() after "
          f"{res['relaunch_read_ms']:.4f} ms (medians of {RELAUNCH_REPS}; "
          f"{smi})", flush=True)
    return res


if __name__ == "__main__":
    main()
