#!/usr/bin/env python3
"""A/B of the Gibbs segment kernels' per-cell step on one CUDA device.

    python3 scripts/ab_gibbs_step.py [--parent DIR] [--rounds 2]
                                     [--json FILE]

Builds variants of bnpc_tpu_torch/csrc/{gibbs_common.cuh, lazy_segment.cu,
lazy_stream.cu} into scratch libraries (nothing in the package changes),
checks that every variant gives the tree's targets, sizes and info on a
no-birth, a birth and a veto case, and times each, in turns, at

    k3_131072x128   lazy_stream, full no-birth segment, Z 67 MB (misses L2)
    k3_5000x256     lazy_stream, full no-birth segment, Z in L2
    k1_5000x256     lazy_segment, full no-birth segment, Z in L2
    k1_131072x128   lazy_segment on the 131,072 x 128 Z in cell order

The variants are the tree's sources with one part of the design taken out
by a text patch (the script fails if a patch no longer applies):

    tree              the sources as they are
    shuffle_trees     best / first index / free slot by 5-round shuffle
                      trees instead of redux.sync
    logf_on_chain     no second cached row: the gaining slot's new weight
                      is a logf after the pick
    no_canon          the key map without x + 0.0f (timing only)
    ring4             4 rows in the cp.async ring instead of 8
    no_ring           lazy_segment with the next cell's row prefetched one
                      cell ahead into registers, and no ring
    parent            (--parent DIR: a checkout of the commit before the
                      redesign, 35957c4) its sources as they are
    parent_redux      the parent's step (SPL logf a lane a cell) with its
                      shuffle trees replaced by redux.sync: lazy_stream only
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bnpc_tpu_torch.ops import _build  # noqa: E402
from bnpc_tpu_torch.probes import card, cuda_ms  # noqa: E402

CSRC = ROOT / "bnpc_tpu_torch" / "csrc"
HEADER, SEG, STREAM = "gibbs_common.cuh", "lazy_segment.cu", "lazy_stream.cu"


def patch(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"patch no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


SHUFFLE_TREES = [
    ("__reduce_max_sync(kFull, key_of(tree_fmax<SPL>(logit)))",
     "key_of(warp_max(tree_fmax<SPL>(logit)))"),
    ("__reduce_min_sync(kFull, tree_min<SPL>(hit))",
     "warp_min(tree_min<SPL>(hit))"),
    ("__reduce_min_sync(kFull, tree_min<SPL>(zero))",
     "warp_min(tree_min<SPL>(zero))"),
]
LOGF_ON_CHAIN = [
    ("      c.sz[s] += 1.f;\n      c.w[s] = c.wp[s];",
     "      c.sz[s] += 1.f;\n      c.w[s] = wt;"),
    ("  const bool apply = !(remove && p.t == old_next);\n",
     "  const bool apply = !(remove && p.t == old_next);\n"
     "  const float wt = log_weight(lane_value<SPL>(c.sz, p.t) + 1.f,"
     " c.log_denom);\n"),
]
NO_CANON = [("__float_as_uint(x + 0.0f)", "__float_as_uint(x)")]
RING4 = [("constexpr int kRing = 8;", "constexpr int kRing = 4;")]

# lazy_segment's kernel body without the ring: everything between the Chunk
# struct and the launcher is replaced.
NO_RING_KERNEL = r'''template <int SPL>
__global__ void __launch_bounds__(32, 1) lazy_segment_kernel(
    const float* __restrict__ z, const float* __restrict__ aux,
    const int* __restrict__ assign, const int* __restrict__ perm,
    float* __restrict__ sizes, int* __restrict__ tgt_out,
    int* __restrict__ info, const float* __restrict__ log_denom_p, int n,
    int i0) {
  constexpr int K = 32 * SPL;
  const int lane = threadIdx.x;
  Chain<SPL> c;
  chain_init<SPL>(c, sizes, K, *log_denom_p, lane);
  int veto = 0, birth_pos = -1, birth_cell = -1, birth_slot = -1;
  int cell = 0;
  float a = 0.f, v[SPL];
  if (i0 < n) {
    cell = perm[i0];
    chain_remove_first<SPL>(c, assign[cell], lane);
    a = aux[cell];
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = z[(size_t)cell * K + s * 32 + lane];
  }
  for (int i = i0; i < n; ++i) {
    int cell_n = 0, old_n = 0;
    float a_n = 0.f, v_n[SPL];
    if (i + 1 < n) {
      cell_n = perm[i + 1];
      old_n = assign[cell_n];
      a_n = aux[cell_n];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = z[(size_t)cell_n * K + s * 32 + lane];
    }
    const Pick p = chain_step<SPL>(c, v, a, old_n, i + 1 < n, true, lane);
    veto |= (p.cand && !p.is_new) ? 1 : 0;
    if (lane == 0) tgt_out[i] = p.t;
    if (p.is_new) {
      birth_pos = i;
      birth_cell = cell;
      birth_slot = p.t;
      break;
    }
    cell = cell_n;
    a = a_n;
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
  }
  chain_store<SPL>(c, sizes, K, lane);
  if (lane == 0) {
    info[0] = birth_pos >= 0 ? birth_pos + 1 : n;
    info[1] = birth_cell;
    info[2] = birth_slot;
    info[3] = veto;
  }
}

'''

# The parent's reductions (gibbs_common.cuh::pick_reg at 35957c4) and their
# redux.sync replacement.
PARENT_KEYS = '''__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}
__device__ __forceinline__ float float_of_key(unsigned key) {
  return __uint_as_float(key ^ (~(unsigned)((int)key >> 31) | 0x80000000u));
}

struct Pick {'''
PARENT_TREES = '''  float logit[SPL];
  float best = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    logit[s] = logit_of(v[s], sz[s], log_denom);
    best = fmaxf(best, logit[s]);
  }
  best = warp_max(best);

  int free_l = KT, idx_l = KT;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (sz[s] == 0.f) free_l = min(free_l, slot);
    if (logit[s] == best) idx_l = min(idx_l, slot);
  }
  const int free_slot = warp_min(free_l);
  const int idx = warp_min(idx_l);
'''
PARENT_REDUX = '''  unsigned key[SPL];
  unsigned best_l = 0;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    key[s] = key_of(logit_of(v[s], sz[s], log_denom));
    best_l = max(best_l, key[s]);
  }
  const unsigned best_key = __reduce_max_sync(kFull, best_l);
  const float best = float_of_key(best_key);
  int free_l = KT, idx_l = KT;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (sz[s] == 0.f) free_l = min(free_l, slot);
    if (key[s] == best_key) idx_l = min(idx_l, slot);
  }
  const int free_slot = __reduce_min_sync(kFull, free_l);
  const int idx = __reduce_min_sync(kFull, idx_l);
'''


def variants(parent):
    """{name: ({file: text}, has lazy_segment)}."""
    src = {f: (CSRC / f).read_text() for f in (HEADER, SEG, STREAM)}
    seg = src[SEG]
    no_ring = (seg[:seg.index("// perm, and assign / aux gathered")]
               + NO_RING_KERNEL
               + seg[seg.index("template <int SPL>\nvoid launch("):])

    def with_header(pairs):
        return {**src, HEADER: patch(src[HEADER], pairs)}

    out = {
        "tree": (src, True),
        "shuffle_trees": (with_header(SHUFFLE_TREES), True),
        "logf_on_chain": (with_header(LOGF_ON_CHAIN), True),
        "no_canon": (with_header(NO_CANON), True),
        "ring4": (with_header(RING4), True),
        "no_ring": ({**src, SEG: no_ring}, True),
    }
    if parent:
        pdir = Path(parent) / "bnpc_tpu_torch" / "csrc"
        old = {f: (pdir / f).read_text() for f in (HEADER, SEG, STREAM)}
        out["parent"] = (old, True)
        out["parent_redux"] = ({
            HEADER: patch(old[HEADER], [("struct Pick {", PARENT_KEYS),
                                        (PARENT_TREES, PARENT_REDUX)]),
            STREAM: old[STREAM]}, False)
    return out


def build(vs, work):
    """One nvcc per source of every variant, all at once; returns
    {name: CDLL} and prints the step kernels' registers."""
    nvcc = _build._nvcc()
    procs = []
    for name, (files, _) in vs.items():
        d = work / name
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        for f in files:
            if f.endswith(".cu"):
                obj = d / (f[:-3] + ".o")
                procs.append((name, f, subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                     str(d / f)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
    for name, f, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}/{f}:\n{log}")
        if name in ("tree", "parent"):
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and (
                        "ILi4E" in line or "ILi8E" in line):
                    spl = 4 if "ILi4E" in line else 8
                    use = [x.strip() for x in lines[i + 1:i + 4]
                           if "registers" in x or "spill" in x]
                    print(f"  {name}/{f} SPL {spl}: " + "; ".join(use))
    libs = {}
    for name in vs:
        d = work / name
        so = d / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(so),
                        *map(str, d.glob("*.o"))], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("bnpc_lazy_segment", "bnpc_lazy_stream"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def seg(lib, z, aux, assign, perm, sizes, tgt, info, i0, ld):
    rc = lib.bnpc_lazy_segment(
        z.data_ptr(), aux.data_ptr(), assign.data_ptr(), perm.data_ptr(),
        sizes.data_ptr(), tgt.data_ptr(), info.data_ptr(), ld.data_ptr(),
        perm.shape[0], z.shape[1], i0, _stream())
    _build.check_launch(rc, "bnpc_lazy_segment")


def stream(lib, zp, auxp, assignp, sizes, tgt, info, i0, ld):
    rc = lib.bnpc_lazy_stream(
        zp.data_ptr(), auxp.data_ptr(), assignp.data_ptr(), sizes.data_ptr(),
        tgt.data_ptr(), info.data_ptr(), ld.data_ptr(), zp.shape[0],
        zp.shape[1], i0, _stream())
    _build.check_launch(rc, "bnpc_lazy_stream")


def case(rng, n, k_pad, live, hot, dev):
    """(assign, aux, sizes): `live` slots hold the cells, aux +1e30 at the
    `hot` indices and -1e30 elsewhere."""
    assign = rng.integers(0, live, n)
    aux = np.full(n, -1e30, np.float32)
    aux[hot] = 1e30
    sizes = np.bincount(assign, minlength=k_pad).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (assign.astype(np.int32), aux, sizes))


def run(fn, lib, args, n, sizes0, i0, ld, dev):
    sizes = sizes0.clone()
    tgt = torch.full((n,), -7, dtype=torch.int32, device=dev)
    info = torch.zeros((4,), dtype=torch.int32, device=dev)
    fn(lib, *args, sizes, tgt, info, i0, ld)
    torch.cuda.synchronize()
    return tgt, sizes, info


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", help="also write the times to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_gibbs_step: no CUDA device")
    dev = "cuda"
    print(card())
    vs = variants(args.parent)
    work = Path(tempfile.mkdtemp(prefix="ab_gibbs_step_"))
    try:
        libs = build(vs, work)
        has_seg = {name: v[1] for name, v in vs.items()}

        rng = np.random.default_rng(2)

        def t(x):
            return torch.from_numpy(x).to(dev)

        def ld_of(n):
            return torch.tensor(np.log(n - 1.0 + 10.0), dtype=torch.float32,
                                device=dev)

        n_l, k_l, n_s, k_s = 131072, 128, 5000, 256
        z_l = t((rng.standard_normal((n_l, k_l)) * 4.0).astype(np.float32))
        z_s = t((rng.standard_normal((n_s, k_s)) * 4.0).astype(np.float32))
        perm_l = t(rng.permutation(n_l).astype(np.int32))
        perm_s = t(rng.permutation(n_s).astype(np.int32))
        ps = perm_s.cpu().numpy()
        zp_s = z_s[perm_s.long()].contiguous()
        cases_l = {"no_birth": (case(rng, n_l, k_l, 100, [], dev), 0),
                   "birth": (case(rng, n_l, k_l, 100, [n_l - 4000], dev),
                             n_l - 8192 + 13)}
        cases_s = {"no_birth": (case(rng, n_s, k_s, 200, [], dev), 0),
                   "birth": (case(rng, n_s, k_s, 200, ps[[2600]], dev), 1003),
                   "veto": (case(rng, n_s, k_s, 256, ps[:5], dev), 0)}

        def outputs(name):
            lib, out = libs[name], []
            for (assign, aux, s0), i0 in cases_l.values():
                out.append(run(stream, lib, (z_l, aux, assign), n_l, s0, i0,
                               ld_of(n_l), dev))
                if has_seg[name]:
                    out.append(run(seg, lib, (z_l, aux, assign, perm_l), n_l,
                                   s0, i0, ld_of(n_l), dev))
            for (assign, aux, s0), i0 in cases_s.values():
                pl = perm_s.long()
                out.append(run(stream, lib, (zp_s, aux[pl], assign[pl]), n_s,
                               s0, i0, ld_of(n_s), dev))
                if has_seg[name]:
                    out.append(run(seg, lib, (z_s, aux, assign, perm_s), n_s,
                                   s0, i0, ld_of(n_s), dev))
            return out

        want = outputs("tree")
        for name in libs:
            got = outputs(name)
            ref = want if has_seg[name] else [
                w for w, keep in zip(want, [True, False] * 5) if keep]
            same = all(torch.equal(x, y) for g, r in zip(got, ref)
                       for x, y in zip(g, r))
            print(f"  {name}: outputs {'==' if same else '!='} tree "
                  f"({len(got)} segments)")
            if not same:
                raise SystemExit(f"{name} disagrees with the tree")

        (a_l, x_l, s_l), _ = cases_l["no_birth"]
        (a_s, x_s, s_s), _ = cases_s["no_birth"]
        pl = perm_s.long()
        tgt_l = torch.empty((n_l,), dtype=torch.int32, device=dev)
        tgt_s = torch.empty((n_s,), dtype=torch.int32, device=dev)
        info = torch.empty((4,), dtype=torch.int32, device=dev)
        res = {name: {} for name in libs}
        for _ in range(args.rounds):
            for name, lib in libs.items():
                def timed(fn, fargs, s0, tgt, n, reps):
                    buf = iter([s0.clone() for _ in range(reps)])
                    return cuda_ms(lambda: fn(lib, *fargs, next(buf), tgt,
                                              info, 0, ld_of(n)), reps)
                r = res[name]
                r.setdefault("k3_131072x128", []).append(
                    timed(stream, (z_l, x_l, a_l), s_l, tgt_l, n_l, 7))
                r.setdefault("k3_5000x256", []).append(
                    timed(stream, (zp_s, x_s[pl], a_s[pl]), s_s, tgt_s, n_s,
                          21))
                if has_seg[name]:
                    r.setdefault("k1_5000x256", []).append(
                        timed(seg, (z_s, x_s, a_s, perm_s), s_s, tgt_s, n_s,
                              21))
                    r.setdefault("k1_131072x128", []).append(
                        timed(seg, (z_l, x_l, a_l, perm_l), s_l, tgt_l, n_l,
                              7))
        print(f"median ms per full no-birth segment, one value a round "
              f"({card()}):")
        for name, r in res.items():
            print(f"  {name:14s} " + "  ".join(
                f"{k} {'/'.join(f'{x:.4f}' for x in v)}"
                for k, v in r.items()))
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            Path(args.json).write_text(json.dumps({"card": card(),
                                                   "ms": res}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
