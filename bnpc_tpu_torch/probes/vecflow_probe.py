"""Probe: the lazy segment's per-cell chain with its targets kept in
registers and the birth checked once per 128-cell batch, against the
shipped kernel (csrc/lazy_segment.cu).

Counterpart of benchmarks/vecflow_probe.py (its kernel ``_vecflow_kernel``,
called through ``vecflow``). The kernel (csrc/vecflow_probe.cu) runs
lazy_segment's loop and per-cell step over positions 0, 1, ... in batches
of 128, and differs from lazy_segment only in the TPU probe's two ideas: a
batch's targets leave registers once a batch, and the birth is tested once
a batch. So its time beside lazy_segment's is what those two ideas buy.

* a position i >= n of the last batch is inert (cell perm[n - 1], nothing
  removed or added, no birth); its target, the first argmax, is written too;
* a birth does not stop its batch: the batch's later cells see the newborn
  slot at size 1, and the run ends after that batch;
* ``tgt`` [ceil(n / 128), 128] f32 receives the targets of the batches run
  (later rows are left as they were), ``info`` [1] i32 the first birth's
  position, or n; ``sizes`` [k_pad] f32 is updated in place.

A CPU tensor goes to the plain twin; a CUDA tensor goes to the kernel or
the wrapper raises.

    python -m bnpc_tpu_torch.probes.vecflow_probe

runs the TPU probe's main() on the card: seed 0, 12 live clusters, aux
-inf (no birth), log_denom 8.5; checks that both kernels give the same
targets, sizes and info; prints both times beside the card's name and power
limit.
"""

from __future__ import annotations

import numpy as np
import torch

from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.ops.cuda_gibbs import (_SLOTS_PER_LANE, lazy_segment,
                                           pick_ref)
from bnpc_tpu_torch.probes import card, cuda_ms, parse_args

N, K_PAD = 5000, 256
BATCH = 128
LOG_DENOM = 8.5

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def n_batches(n: int) -> int:
    return -(-n // BATCH)


def vecflow_ref(z, aux, assign, perm, sizes, tgt, info, log_denom):
    """Plain torch twin of the kernel: the same batches, the same float32
    expressions (cuda_gibbs.pick_ref), the same inert tail."""
    n, k_pad = perm.shape[0], z.shape[1]
    perm_h, assign_h = perm.tolist(), assign.tolist()
    birth = n
    for b in range(n_batches(n)):
        for j in range(BATCH):
            i = b * BATCH + j
            cell = perm_h[min(i, n - 1)]
            guard = i < n
            if guard:
                sizes[assign_h[cell]] -= 1.0
            cand, free, idx = pick_ref(z[cell], sizes, aux[cell], log_denom)
            is_new = guard and bool(cand) and free < k_pad
            t = free if is_new else idx
            if guard:
                sizes[t] += 1.0
            tgt[b, j] = float(t)
            if is_new:
                birth = min(birth, i)
        if birth < n:
            break
    info.fill_(birth)


def vecflow(z, aux, assign, perm, sizes, tgt, info, log_denom):
    """Run the probe's sweep (see the module docstring).

    z [round_up(n, 8), k_pad] f32; aux [n] f32; assign, perm [n] i32;
    sizes [k_pad] f32; tgt [ceil(n / 128), 128] f32; info [1] i32;
    log_denom 0-d f32 tensor.
    """
    if z.device.type == "cpu":
        return vecflow_ref(z, aux, assign, perm, sizes, tgt, info, log_denom)
    if z.device.type != "cuda":
        raise ValueError(f"vecflow: unsupported device {z.device}")
    n, k_pad = perm.shape[0], z.shape[1]
    if k_pad not in tuple(32 * s for s in _SLOTS_PER_LANE):
        raise ValueError(f"vecflow: k_pad={k_pad} unsupported")
    if n < 1:
        raise ValueError("vecflow: n must be positive")
    dev = z.device
    f32, i32 = torch.float32, torch.int32
    _build.check_tensor(z, "z", f32, (-(-n // 8) * 8, k_pad), dev)
    _build.check_tensor(aux, "aux", f32, (n,), dev)
    _build.check_tensor(assign, "assign", i32, (n,), dev)
    _build.check_tensor(perm, "perm", i32, (n,), dev)
    _build.check_tensor(sizes, "sizes", f32, (k_pad,), dev)
    _build.check_tensor(tgt, "tgt", f32, (n_batches(n), BATCH), dev)
    _build.check_tensor(info, "info", i32, (1,), dev)
    _build.check_tensor(log_denom, "log_denom", f32, (), dev)
    lib = _build.load_library()
    global launches
    launches += 1
    rc = lib.bnpc_vecflow(
        z.data_ptr(), aux.data_ptr(), assign.data_ptr(), perm.data_ptr(),
        sizes.data_ptr(), tgt.data_ptr(), info.data_ptr(),
        log_denom.data_ptr(), n, k_pad,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "bnpc_vecflow")


def make_inputs(n, k_pad, device, seed=0):
    """The TPU probe's input: (z, aux, assign, perm, sizes, log_denom)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(-(-n // 8) * 8, k_pad)).astype(np.float32)
    assign = rng.integers(0, 12, n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    sizes = np.full(k_pad, -1.0, np.float32)
    sizes[:12] = np.bincount(assign, minlength=12)
    aux = np.full(n, -np.inf, np.float32)  # no births
    return (*(torch.from_numpy(x).to(device)
              for x in (z, aux, assign, perm, sizes)),
            torch.tensor(LOG_DENOM, dtype=torch.float32, device=device))


# Crafted inputs on which the kernel must equal the twin: (n, k_pad, birth
# positions) of crafted_inputs.
CRAFTED = {"n_multiple_of_128": (256, 64, []),
           "n_1": (1, 32, []),
           "n_below_ring": (5, 64, [3]),
           "birth_at_0": (200, 64, [0]),
           "birth_in_last_full_batch": (300, 64, [200]),
           "birth_in_tail": (300, 128, [280]),
           "two_births_one_batch": (300, 64, [130, 140])}


def crafted_inputs(name, k_pad=None):
    """One crafted case as numpy arrays: (z, aux, assign, perm, sizes,
    log_denom, info[0] it must give). 12 live slots, 20-23 free, aux +1e30
    at the case's birth positions and -inf elsewhere."""
    n, k, births = CRAFTED[name]
    k = k_pad or k
    rng = np.random.default_rng(len(name))
    z = (rng.standard_normal((-(-n // 8) * 8, k)) * 3.0).astype(np.float32)
    assign = rng.integers(0, 12, n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    sizes = np.full(k, -1.0, np.float32)
    sizes[:12] = np.bincount(assign, minlength=12)
    sizes[20:24] = 0.0
    aux = np.full(n, -np.inf, np.float32)
    aux[perm[births]] = 1e30
    return (z, aux, assign, perm, sizes, np.float32(LOG_DENOM),
            births[0] if births else n)


def main(argv=None) -> dict:
    args = parse_args(argv, "vecflow probe against lazy_segment")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("vecflow_probe: no CUDA device (--device cpu runs "
                         "the plain twins)")
    n, k_pad = N, K_PAD
    z, aux, assign, perm, sizes0, log_denom = make_inputs(n, k_pad, dev)
    tgt_v = torch.full((n_batches(n), BATCH), -7.0, device=dev)
    info_v = torch.empty((1,), dtype=torch.int32, device=dev)
    tgt_l = torch.empty((n,), dtype=torch.int32, device=dev)
    info_l = torch.empty((4,), dtype=torch.int32, device=dev)
    sizes_v, sizes_l = sizes0.clone(), sizes0.clone()
    vecflow(z, aux, assign, perm, sizes_v, tgt_v, info_v, log_denom)
    lazy_segment(z[:n], aux, assign, perm, sizes_l, tgt_l, info_l, 0,
                 log_denom)
    same = (torch.equal(tgt_v.reshape(-1)[:n].to(torch.int32), tgt_l),
            torch.equal(sizes_v, sizes_l),
            int(info_v[0]) == int(info_l[0]) == n)
    print(f"vecflow_probe (n={n}, k_pad={k_pad}, {dev}): targets equal "
          f"{same[0]}, sizes equal {same[1]}, info {int(info_v[0])} "
          f"{int(info_l[0])}", flush=True)
    if not all(same):
        raise AssertionError("vecflow and lazy_segment disagree")
    out = {"n": n, "k_pad": k_pad}
    if dev.type != "cuda":
        print("timing needs a CUDA device; none taken")
        return out

    def fresh(count):
        return iter([sizes0.clone() for _ in range(count)])

    reps = 31
    buf = fresh(reps)
    out["vecflow_ms"] = cuda_ms(lambda: vecflow(
        z, aux, assign, perm, next(buf), tgt_v, info_v, log_denom), reps)
    buf = fresh(reps)
    out["lazy_segment_ms"] = cuda_ms(lambda: lazy_segment(
        z[:n], aux, assign, perm, next(buf), tgt_l, info_l, 0, log_denom),
        reps)
    smi = card()
    for name in ("vecflow", "lazy_segment"):
        ms = out[f"{name}_ms"]
        print(f"{name}: {ms:.4f} ms ({ms / n * 1e3:.4f} us/cell; median of "
              f"{reps}, CUDA events; {smi})", flush=True)
    return out


if __name__ == "__main__":
    main()
