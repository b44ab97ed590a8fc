#!/usr/bin/env python3
"""A/B of the sampler kernels' designs on one CUDA device.

    python3 scripts/ab_gibbs_step.py [--parent DIR] [--rounds 2]
                                     [--json FILE] [--only step,k4,k2,k6,k5]
                                     [--sass DIR]

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
    parent            (--parent DIR: a checkout of the commit before the
                      redesign, 35957c4) its sources as they are:
                      lazy_stream only (kernel 1's C entry has since gained
                      its bound scratch and full-pick count)
    parent_redux      the parent's step (SPL logf a lane a cell) with its
                      shuffle trees replaced by redux.sync: lazy_stream only

`--only k4` does the same for the eager sweep (sweep.cu), at 5,000 x 256
with lf [5,000, 5,000]: every variant must give the tree's assignment,
sizes and params on a no-birth, a two-births and a veto sweep, and is timed
on the no-birth and the two-births sweep (z warm in L2, as after the
likelihood product):

    k4_tree           the sources as they are
    k4_runtime_cols   the run-time columns of row_cols also where the row is
                      exactly 32 * SPL wide (no compile-time offsets)
    k4_no_ring        no cp.async ring: the next cell's row by plain loads
                      one cell ahead, in the same one-block loop
    k4_branchy        the ring's copy and the next cell's loads behind
                      `if (i + 1 < n)`, as the loop before the redesign had
                      its loads
    k4_no_chunks      perm, assign and aux loaded straight from global
                      memory every cell instead of from the chunk registers
    k4_birth_in_loop  the birth handled inside the loop's block (patch, then
                      element t of every row in the ring set anew) instead
                      of leaving the loop and starting it again
    k4_patch_wide<D>  the birth's column patch with D rows a lane in
                      flight instead of one
    k4_parent         (--parent DIR: a checkout of the commit before this
                      kernel's redesign, 83beae6) its sweep.cu and header

`--only k2` does it for the restricted scan (rg_scan.cu), at 5,000 cells
(s_count 5,000 and 1,000, and 5,000 on a non-monotone table, the serial
route) and at 131,072 cells (s_count = n and 6,553); every variant must
give the tree's sides on all five:

    k2_tree           the sources as they are
    k2_t<T>_g<G>      T threads a block (a chunk is T - 32 positions) and
                      groups of G positions in the chain's loop
    k2_parent         (--parent DIR, 83beae6 likewise) its rg_scan.cu, one
                      thread

`--only k6` and `--only k5` do it for the probes' kernels, each beside
kernel 1 (`k1_yardstick`, the tree's lazy_segment.cu) on the same input in
the same turns. Every variant must give the tree's targets, sizes (NaN for
NaN) and info on the probe's crafted cases (while_probe.CRAFTED at k_pad
32, 256 and 1,024, 128 cells; vecflow_probe.CRAFTED at its widths and at
k_pad 256) and on the timed input. Kernel 6 (while_probe.cu) is timed on
its probe's full no-birth run at 512 x 256:

    k6_tree           the sources as they are
    k6_logf_all       no cached weights: SPL logf a lane a cell, as before
                      the redesign
    k6_shuffle_trees  the max key by a five-round shuffle tree and the two
                      first indices by warp_min, as before the redesign
    k6_parent         (--parent DIR, a5b388e) its while_probe.cu and header

Kernel 5 (vecflow_probe.cu) on its probe's no-birth sweep at 5,000 x 256 (Z
in L2) and on the 131,072 x 128 Z in cell order (Z misses L2):

    k5_tree           the sources as they are
    k5_no_ring        no cp.async ring: the next position's row by plain
                      loads one position ahead, as before the redesign
    k5_store_each_cell  each target stored by lane 0 at its cell, as
                      kernel 1 does, not kept and stored once a batch
    k5_chunks_rolled  the batch's four 32-position chunks in a loop that is
                      not unrolled (`#pragma unroll 1`), each chunk's
                      targets stored as it ends
    k5_parent         (--parent DIR, a5b388e) its vecflow_probe.cu and header

`--sass DIR` writes `cuobjdump -sass` of every variant's objects there.
"""

import argparse
import ctypes
import json
import os
import re
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
SWEEP, RG = "sweep.cu", "rg_scan.cu"
WHILE, VECFLOW = "while_probe.cu", "vecflow_probe.cu"


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

    def with_header(pairs):
        return {**src, HEADER: patch(src[HEADER], pairs)}

    out = {
        "tree": (src, True),
        "shuffle_trees": (with_header(SHUFFLE_TREES), True),
        "logf_on_chain": (with_header(LOGF_ON_CHAIN), True),
        "no_canon": (with_header(NO_CANON), True),
        "ring4": (with_header(RING4), True),
    }
    if parent:
        pdir = Path(parent) / "bnpc_tpu_torch" / "csrc"
        old = {f: (pdir / f).read_text() for f in (HEADER, SEG, STREAM)}
        out["parent"] = (old, False)
        out["parent_redux"] = ({
            HEADER: patch(old[HEADER], [("struct Pick {", PARENT_KEYS),
                                        (PARENT_TREES, PARENT_REDUX)]),
            STREAM: old[STREAM]}, False)
    return out

# ---------------------------------------------------------------------------
# Kernel 4 (sweep.cu): one part of the loop taken out at a time
# ---------------------------------------------------------------------------

K4_RUNTIME_COLS = [("  if (k_pad == 32 * SPL) {", "  if (false) {")]
K4_NO_CHUNKS = [
    ("        issue(r, pair_at(cur.cell, nxt.cell, r - cb));\n"
     "        const int cell = __shfl_sync(kFull, cur.cell, i - cb);",
     "        issue(r, perm[min(r, n - 1)]);\n"
     "        const int cell = perm[i];"),
    ("        const float a_n = pair_at(cur.a, nxt.a, i + 1 - cb);",
     "        const float a_n = aux[perm[min(i + 1, n - 1)]];"),
    ("        const int old_n2 = pair_at(cur.o, nxt.o, i + 2 - cb);",
     "        const int old_n2 = assign[perm[min(i + 2, n - 1)]];"),
]
K4_BRANCHY = [
    ("        __syncwarp();\n        const int r = i + kRing - 1;",
     "        __syncwarp();\n        int old_n2 = 0;\n"
     "        float a_n = 0.f, v_n[SPL];\n"
     "        const int cell = __shfl_sync(kFull, cur.cell, i - cb);\n"
     "        if (i + 1 < n) {\n        const int r = i + kRing - 1;"),
    ("        const int cell = __shfl_sync(kFull, cur.cell, i - cb);\n"
     "        const float a_n = pair_at(", "        a_n = pair_at("),
    ("        const int old_n2 = pair_at(", "        old_n2 = pair_at("),
    ("        float v_n[SPL];\n#pragma unroll\n"
     "        for (int s = 0; s < SPL; ++s)\n"
     "          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];\n",
     "#pragma unroll\n"
     "        for (int s = 0; s < SPL; ++s)\n"
     "          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];\n"
     "        }\n"),
]
# No ring: the next cell's row by plain loads at the clamped columns, one
# cell ahead; a restart reads its first row the same way.
K4_NO_RING = [
    ("      for (int r = i; r < i + kRing - 1; ++r)\n"
     "        issue(r, pair_at(cur.cell, nxt.cell, r - cb));\n", ""),
    ("      cp_async_wait<kRing - 2>();  // row i has landed (this lane's "
     "part)\n#pragma unroll\n"
     "      for (int s = 0; s < SPL; ++s)\n"
     "        v[s] = ring[(unsigned)i % kRing][s * 32 + lane];",
     "      {\n        const float* row0 =\n"
     "            z + (size_t)pair_at(cur.cell, nxt.cell, i - cb) * k_pad;\n"
     "#pragma unroll\n"
     "        for (int s = 0; s < SPL; ++s) v[s] = row0[col[s]];\n      }"),
    ("        const int r = i + kRing - 1;\n"
     "        issue(r, pair_at(cur.cell, nxt.cell, r - cb));\n",
     "        const float* row_n =\n"
     "            z + (size_t)pair_at(cur.cell, nxt.cell, i + 1 - cb) * k_pad;"
     "\n"),
    ("        cp_async_wait<kRing - 2>();  // position i + 1's row has landed"
     "\n", ""),
    ("          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];\n",
     "          v_n[s] = row_n[col[s]];\n"),
]
# The birth handled inside the loop's block instead of leaving it: patch,
# land every copy, set element t of the rows already in the ring (a lane a
# row) and take the register row anew.
K4_BIRTH_IN_LOOP = [
    ("        if (p.is_new) {\n          born_cell = cell;\n"
     "          born_slot = p.t;\n          break;\n        }\n",
     "        if (p.is_new) {\n"
     "          patch_birth(z, gum, lf, fresh, params, n, k_pad, m, cell, "
     "p.t,\n                      lane);\n"
     "          cp_async_wait_all();\n          __syncwarp();\n"
     "          const int d = min(max(lane, 1), kRing - 1);\n"
     "          const int cell_d = pair_at(cur.cell, nxt.cell, i + d - cb);\n"
     "          if (lane >= 1 && lane < kRing)\n"
     "            ring[(unsigned)(i + d) % kRing][p.t] =\n"
     "                lf[(size_t)cell_d * n + cell]\n"
     "                + gum[(size_t)cell_d * k_pad + p.t];\n"
     "          __syncwarp();\n#pragma unroll\n"
     "          for (int s = 0; s < SPL; ++s)\n"
     "            v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];\n"
     "        }\n"),
]


def k4_patch_wide(depth):
    """The column patch with `depth` rows a lane in flight (clamped,
    unpredicated loads; predicated stores)."""
    return [(
        "  for (int j = lane; j < n; j += 32)\n"
        "    z[(size_t)j * k_pad + f] = lf[(size_t)j * n + cell]\n"
        "        + gum[(size_t)j * k_pad + f];\n",
        f"  for (int j0 = lane; j0 < n; j0 += 32 * {depth}) {{\n"
        f"    float x[{depth}], g[{depth}];\n#pragma unroll\n"
        f"    for (int u = 0; u < {depth}; ++u) {{\n"
        "      const int j = min(j0 + 32 * u, n - 1);\n"
        "      x[u] = lf[(size_t)j * n + cell];\n"
        "      g[u] = gum[(size_t)j * k_pad + f];\n    }\n#pragma unroll\n"
        f"    for (int u = 0; u < {depth}; ++u) {{\n"
        "      const int j = j0 + 32 * u;\n"
        "      if (j < n) z[(size_t)j * k_pad + f] = x[u] + g[u];\n    }\n"
        "  }\n")]


def variants_k4(parent):
    """{name: ({file: text}, the cases its outputs are compared on)}."""
    src = {f: (CSRC / f).read_text() for f in (HEADER, SWEEP)}
    every = ("no_birth", "two_births", "veto")

    def with_sweep(pairs):
        return {**src, SWEEP: patch(src[SWEEP], pairs)}

    out = {
        "k4_tree": (src, every),
        "k4_runtime_cols": (with_sweep(K4_RUNTIME_COLS), every),
        "k4_no_ring": (with_sweep(K4_NO_RING), every),
        "k4_branchy": (with_sweep(K4_BRANCHY), every),
        "k4_no_chunks": (with_sweep(K4_NO_CHUNKS), every),
        "k4_birth_in_loop": (with_sweep(K4_BIRTH_IN_LOOP), every),
    }
    for depth in (4, 8, 16, 32):
        out[f"k4_patch_wide{depth}"] = (with_sweep(k4_patch_wide(depth)),
                                        every)
    if parent:
        pdir = Path(parent) / "bnpc_tpu_torch" / "csrc"
        out["k4_parent"] = ({f: (pdir / f).read_text()
                             for f in (HEADER, SWEEP)}, every)
    return out


# ---------------------------------------------------------------------------
# Kernel 2 (rg_scan.cu): block and group sizes, the form of the link
# ---------------------------------------------------------------------------

def k2_sizes(text, threads, group):
    """rg_scan.cu with another block size and group size."""
    for name, value in (("kThreads", threads), ("kGroup", group)):
        text, hits = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", text)
        if hits != 1:
            raise SystemExit(f"patch no longer applies: {name}")
    return text


def variants_k2(parent):
    src = {RG: (CSRC / RG).read_text()}

    out = {"k2_tree": (src, None)}
    for threads, group in ((1024, 8), (512, 16), (512, 8), (256, 16),
                           (256, 8), (128, 16)):
        out[f"k2_t{threads}_g{group}"] = (
            {RG: k2_sizes(src[RG], threads, group)}, None)
    if parent:
        out["k2_parent"] = ({RG: (Path(parent) / "bnpc_tpu_torch" / "csrc"
                                  / RG).read_text()}, None)
    return out


# ---------------------------------------------------------------------------
# Kernels 6 and 5 (the probes): one part of the redesign taken out
# ---------------------------------------------------------------------------

K6_LOGF_ALL = [("key[s] = nan_key(v[s] + c.w[s]);",
                "key[s] = nan_key(v[s] + nan_log_weight(c.sz[s]));")]
K6_SHUFFLE_TREES = [
    ("template <int N>\n__device__ __forceinline__ unsigned tree_umax(",
     "__device__ __forceinline__ unsigned warp_umax(unsigned x) {\n"
     "#pragma unroll\n"
     "  for (int off = 16; off > 0; off >>= 1)\n"
     "    x = max(x, __shfl_xor_sync(kFull, x, off));\n"
     "  return x;\n}\n\n"
     "template <int N>\n__device__ __forceinline__ unsigned tree_umax("),
    ("__reduce_max_sync(kFull, tree_umax<SPL>(key))",
     "warp_umax(tree_umax<SPL>(key))"),
    *SHUFFLE_TREES[1:],
]
# No ring: position i + 1's row by plain loads in the loop's block, and
# position 0's before it.
K5_NO_RING = [
    ("  for (int d = 0; d < kRing - 1; ++d) {\n"
     "    issue_row_full<SPL>(ring_s + d * kRowBytes,\n"
     "                        z_lane + (size_t)pair_at(cur.cell, nxt.cell, d)"
     " * K);\n    cp_async_commit();\n  }\n", ""),
    ("  cp_async_wait<kRing - 2>();  // row 0 has landed (this lane's part)\n"
     "#pragma unroll\n"
     "  for (int s = 0; s < SPL; ++s) v[s] = ring[0][s * 32 + lane];",
     "#pragma unroll\n"
     "  for (int s = 0; s < SPL; ++s)\n"
     "    v[s] = z_lane[(size_t)pair_at(cur.cell, nxt.cell, 0) * K + s * 32];"),
    ("        const int r = i + kRing - 1;\n"
     "        issue_row_full<SPL>(\n"
     "            ring_s + (unsigned)r % kRing * kRowBytes,\n"
     "            z_lane + (size_t)pair_at(cur.cell, nxt.cell, j + kRing - 1)"
     " * K);\n        cp_async_commit();\n", ""),
    ("        cp_async_wait<kRing - 2>();  // position i + 1's row has landed"
     "\n", ""),
    ("          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];",
     "          v_n[s] = z_lane[(size_t)pair_at(cur.cell, nxt.cell, j + 1) * K"
     "\n                          + s * 32];"),
]


# The targets stored a cell at a time (lane 0), as kernel 1 does, instead
# of kept in registers and stored once a batch; only the inert positions'
# targets are left to the batch's store.
K5_STORE_EACH_CELL = [
    ("        if (lane == j) w[q] = (float)p.t;\n",
     "        if (lane == 0) tgt_out[i] = (float)p.t;\n"),
    ("    for (int q = 0; q < kChunks; ++q) tgt_out[base + 32 * q + lane] = "
     "w[q];",
     "    for (int q = 0; q < kChunks; ++q)\n"
     "      if (base + 32 * q + lane >= n) tgt_out[base + 32 * q + lane] = "
     "w[q];"),
]


# The batch's four chunks in a loop the compiler may not unroll, each
# chunk's targets stored as it ends (the inert ones at the batch's end).
K5_CHUNKS_ROLLED = [
    ("    float w[kChunks];  // w[q] on lane l: position b * 128 + 32 q + l\n"
     "#pragma unroll\n    for (int q = 0; q < kChunks; ++q) {\n"
     "      const int end = min(32, n - cb);  // 32 but in the ragged last "
     "batch\n",
     "    float w[kChunks];\n#pragma unroll 1\n"
     "    for (int q = 0; q < kChunks; ++q) {\n"
     "      const int end = min(32, n - cb);\n      float wq = 0.f;\n"),
    ("        if (lane == j) w[q] = (float)p.t;\n",
     "        if (lane == j) wq = (float)p.t;\n"),
    ("      cb += 32;\n      cur = nxt;",
     "      if (lane < end) tgt_out[cb + lane] = wq;\n"
     "      cb += 32;\n      cur = nxt;"),
    *K5_STORE_EACH_CELL[1:],
]


def variants_probe(which, parent):
    """{name: ({file: text}, None)} of kernel 6 or 5; the tree's variant
    also holds lazy_segment.cu, the yardstick."""
    src_name = WHILE if which == "k6" else VECFLOW
    src = {f: (CSRC / f).read_text() for f in (HEADER, src_name)}

    def with_src(pairs):
        return {**src, src_name: patch(src[src_name], pairs)}

    out = {f"{which}_tree": ({**src, SEG: (CSRC / SEG).read_text()}, None)}
    if which == "k6":
        out["k6_logf_all"] = (with_src(K6_LOGF_ALL), None)
        out["k6_shuffle_trees"] = (with_src(K6_SHUFFLE_TREES), None)
    else:
        out["k5_no_ring"] = (with_src(K5_NO_RING), None)
        out["k5_store_each_cell"] = (with_src(K5_STORE_EACH_CELL), None)
        out["k5_chunks_rolled"] = (with_src(K5_CHUNKS_ROLLED), None)
    if parent:
        pdir = Path(parent) / "bnpc_tpu_torch" / "csrc"
        out[f"{which}_parent"] = ({f: (pdir / f).read_text()
                                   for f in (HEADER, src_name)}, None)
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
        if name in ("tree", "parent", "k4_tree", "k2_tree", "k6_tree",
                    "k5_tree", "k6_parent", "k5_parent"):
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and f != SEG and (
                        "ILi4E" in line or "ILi8E" in line
                        or "rg_scan_kernel" in line):
                    what = ("SPL 4" if "ILi4E" in line else
                            "SPL 8" if "ILi8E" in line else "scan")
                    use = [x.strip() for x in lines[i + 1:i + 4]
                           if "registers" in x or "spill" in x]
                    print(f"  {name}/{f} {what}: " + "; ".join(use))
    libs = {}
    for name in vs:
        d = work / name
        so = d / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(so),
                        *map(str, d.glob("*.o"))], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("bnpc_lazy_segment", "bnpc_lazy_stream",
                   "bnpc_eager_sweep", "bnpc_rg_scan", "bnpc_while_exit",
                   "bnpc_vecflow"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def seg(lib, z, aux, assign, perm, sizes, tgt, info, i0, ld):
    bounds = torch.empty((3, perm.shape[0]), device=z.device)
    rc = lib.bnpc_lazy_segment(
        z.data_ptr(), aux.data_ptr(), assign.data_ptr(), perm.data_ptr(),
        sizes.data_ptr(), tgt.data_ptr(), info.data_ptr(), ld.data_ptr(),
        bounds.data_ptr(), 0, perm.shape[0], z.shape[1], i0, _stream())
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


def run_step(args, dev, work):
    """The per-cell step's parts on kernels 1 and 3 (module docstring)."""
    vs = variants(args.parent)
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
    return res


def sweep(lib, z, gum, lf, fresh, aux, assign, perm, sizes, params, out,
          ld):
    """One launch of the eager sweep; z, sizes and params are changed in
    place."""
    rc = lib.bnpc_eager_sweep(
        z.data_ptr(), gum.data_ptr(), lf.data_ptr(), fresh.data_ptr(),
        aux.data_ptr(), assign.data_ptr(), perm.data_ptr(), sizes.data_ptr(),
        params.data_ptr(), out.data_ptr(), ld.data_ptr(), z.shape[0],
        z.shape[1], params.shape[1], _stream())
    _build.check_launch(rc, "bnpc_eager_sweep")


def run_k4(args, dev, work):
    """The eager sweep's loop, one part taken out at a time."""
    vs = variants_k4(args.parent)
    libs = build(vs, work)
    n, k, m = 5000, 256, 200
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    z = t((rng.standard_normal((n, k)) * 4.0).astype(np.float32))
    gum = t(rng.gumbel(size=(n, k)).astype(np.float32))
    lf_np = (rng.standard_normal((n, n)) * 4.0).astype(np.float32)
    fresh = t(rng.uniform(1e-5, 1 - 1e-5, (n, m)).astype(np.float32))
    params = t(rng.uniform(1e-5, 1 - 1e-5, (k, m)).astype(np.float32))
    perm_h = rng.permutation(n).astype(np.int32)
    perm = t(perm_h)
    ld = torch.tensor(np.log(n - 1.0 + 10.0), dtype=torch.float32,
                      device=dev)
    lf_b = lf_np.copy()
    lf_b[:, perm_h[[2600, 2601]]] = 30.0
    lf, lf_b = t(lf_np), t(lf_b)
    cases = {"no_birth": (case(rng, n, k, 200, [], dev), lf),
             "two_births": (case(rng, n, k, 200, perm_h[[2600, 2601]], dev),
                            lf_b),
             "veto": (case(rng, n, k, 256, perm_h[:5], dev), lf)}

    def outputs(lib, name):
        (assign, aux, s0), lf_c = cases[name]
        zc, sc, pc = z.clone(), s0.clone(), params.clone()
        out = torch.full((n,), -7, dtype=torch.int32, device=dev)
        sweep(lib, zc, gum, lf_c, fresh, aux, assign, perm, sc, pc, out, ld)
        torch.cuda.synchronize()
        return out, sc, pc

    want = {name: outputs(libs["k4_tree"], name) for name in cases}
    if int((want["two_births"][2] != params).any(dim=1).sum()) != 2:
        raise SystemExit("k4: the two-births case did not give two births")
    for name, lib in libs.items():
        for c in vs[name][1]:
            if not all(torch.equal(x, y)
                       for x, y in zip(outputs(lib, c), want[c])):
                raise SystemExit(f"{name} disagrees with the tree on {c}")
        print(f"  {name}: outputs == tree on {', '.join(vs[name][1])}")

    res = {name: {} for name in libs}
    reps = 21
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    for _ in range(args.rounds):
        for name, lib in libs.items():
            for c in ("no_birth", "two_births"):
                if c not in vs[name][1]:
                    continue
                (assign, aux, s0), lf_c = cases[c]
                # One z for every launch, as warm in L2 as the sweep finds
                # it after the likelihood product: a patched column belongs
                # to a slot that is empty until its birth, so the next
                # launch's cells before the birth never read it.
                zc = z.clone()
                bufs = iter([(s0.clone(), params.clone())
                             for _ in range(reps)])

                def once():
                    sc, pc = next(bufs)
                    sweep(lib, zc, gum, lf_c, fresh, aux, assign, perm, sc,
                          pc, out, ld)

                res[name].setdefault(f"k4_{c}_5000x256", []).append(
                    cuda_ms(once, reps))
    return res


def scan(lib, dz, lau, dtab, sc, c1, out):
    rc = lib.bnpc_rg_scan(dz.data_ptr(), lau.data_ptr(), dtab.data_ptr(),
                          sc.data_ptr(), c1.data_ptr(), out.data_ptr(),
                          dz.shape[0], _stream())
    _build.check_launch(rc, "bnpc_rg_scan")


def run_k2(args, dev, work):
    """The restricted scan: block and group sizes, the form of the link."""
    vs = variants_k2(args.parent)
    libs = build(vs, work)
    rng = np.random.default_rng(1)

    def inputs(n, s_count, swap=False):
        dz = torch.from_numpy(
            (rng.standard_normal(n) * 3.0).astype(np.float32)).to(dev)
        lau = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
        s1r = torch.arange(n + 2, dtype=torch.float32, device=dev)
        dtab = torch.log(s1r + 1.0) - torch.log(
            torch.clamp(s_count - s1r, min=0.0))
        c1 = lau[:s_count].sum().to(torch.int32)
        if swap:
            k = int(c1)
            dtab[[k, k + 3]] = dtab[[k + 3, k]]
        return (dz, lau, dtab,
                torch.tensor(s_count, dtype=torch.int32, device=dev), c1)

    shapes = {"k2_s5000": inputs(5000, 5000),
              "k2_s1000_of_5000": inputs(5000, 1000),
              "k2_s131072": inputs(131072, 131072),
              "k2_s6553_of_131072": inputs(131072, 6553),
              "k2_serial_s5000": inputs(5000, 5000, swap=True)}

    def outputs(lib):
        got = []
        for dz, lau, dtab, sc, c1 in shapes.values():
            out = torch.full((dz.shape[0],), -7, dtype=torch.int32,
                             device=dev)
            scan(lib, dz, lau, dtab, sc, c1, out)
            torch.cuda.synchronize()
            got.append(out)
        return got

    want = outputs(libs["k2_tree"])
    for name, lib in libs.items():
        if not all(torch.equal(x, y) for x, y in zip(outputs(lib), want)):
            raise SystemExit(f"{name} disagrees with the tree")
        print(f"  {name}: outputs == tree ({len(want)} scans)")

    res = {name: {} for name in libs}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            for shape, (dz, lau, dtab, sc, c1) in shapes.items():
                out = torch.empty((dz.shape[0],), dtype=torch.int32,
                                  device=dev)
                reps = 11 if dz.shape[0] > 5000 else 51
                res[name].setdefault(shape, []).append(cuda_ms(
                    lambda: scan(lib, dz, lau, dtab, sc, c1, out), reps))
    return res


def while_exit(lib, z, perm, sizes, out, info, i0):
    rc = lib.bnpc_while_exit(z.data_ptr(), perm.data_ptr(), sizes.data_ptr(),
                             out.data_ptr(), info.data_ptr(), perm.shape[0],
                             z.shape[1], i0, _stream())
    _build.check_launch(rc, "bnpc_while_exit")


def vecflow(lib, z, aux, assign, perm, sizes, tgt, info, ld):
    rc = lib.bnpc_vecflow(z.data_ptr(), aux.data_ptr(), assign.data_ptr(),
                          perm.data_ptr(), sizes.data_ptr(), tgt.data_ptr(),
                          info.data_ptr(), ld.data_ptr(), perm.shape[0],
                          z.shape[1], _stream())
    _build.check_launch(rc, "bnpc_vecflow")


def same(got, want):
    """Equal tensors, NaN for NaN."""
    return all(torch.equal(torch.isnan(x), torch.isnan(y))
               and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)])
               if x.is_floating_point() else torch.equal(x, y)
               for x, y in zip(got, want))


def run_k6(args, dev, work):
    """Kernel 6, one part of the redesign taken out at a time, beside
    kernel 1 on the same z and perm."""
    from bnpc_tpu_torch.probes import while_probe

    vs = variants_probe("k6", args.parent)
    libs = build(vs, work)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    cases = [tuple(t(x) for x in c[:3]) + (c[3],)
             for name in while_probe.CRAFTED for kp in (32, 256, 1024)
             for c in [while_probe.crafted_inputs(name, 128, kp)]]
    n, k = while_probe.N, while_probe.K_PAD
    z, perm, sizes_fin = while_probe.make_inputs(n, k, dev)
    cases.append((z, perm, sizes_fin, 0))

    def outputs(lib):
        got = []
        for zc, pc, s0, i0 in cases:
            sizes = s0.clone()
            out = torch.full((pc.shape[0],), -7, dtype=torch.int32,
                             device=dev)
            info = torch.zeros((4,), dtype=torch.int32, device=dev)
            while_exit(lib, zc, pc, sizes, out, info, i0)
            torch.cuda.synchronize()
            got += [out, sizes, info]
        return got

    want = outputs(libs["k6_tree"])
    for name, lib in libs.items():
        if not same(outputs(lib), want):
            raise SystemExit(f"{name} disagrees with the tree")
        print(f"  {name}: outputs == tree ({len(cases)} runs)")

    assign = (torch.arange(n, device=dev) % 12).to(torch.int32)
    aux = torch.full((n,), -float("inf"), device=dev)
    ld0 = torch.zeros((), device=dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    info = torch.empty((4,), dtype=torch.int32, device=dev)
    res = {name: {} for name in ("k1_yardstick", *libs)}
    reps = 21
    for _ in range(args.rounds):
        for name in res:
            buf = iter([sizes_fin.clone() for _ in range(reps)])

            def once(name=name):
                if name == "k1_yardstick":
                    seg(libs["k6_tree"], z, aux, assign, perm, next(buf), out,
                        info, 0, ld0)
                else:
                    while_exit(libs[name], z, perm, next(buf), out, info, 0)

            res[name].setdefault("512x256", []).append(cuda_ms(once, reps))
    return res


def run_k5(args, dev, work):
    """Kernel 5, one part of the redesign taken out at a time, beside
    kernel 1 on the same inputs."""
    from bnpc_tpu_torch.probes import vecflow_probe

    vs = variants_probe("k5", args.parent)
    libs = build(vs, work)
    rng = np.random.default_rng(4)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    cases = [tuple(t(x) for x in c[:6])
             for name in vecflow_probe.CRAFTED for kp in (None, 256)
             for c in [vecflow_probe.crafted_inputs(name, kp)]]
    main_in = vecflow_probe.make_inputs(5000, 256, dev)
    # The 131,072 x 128 Z in cell order: 100 live slots, no birth.
    n_l, k_l = 131072, 128
    assign_l = rng.integers(0, 100, n_l)
    sizes_l = np.bincount(assign_l, minlength=k_l).astype(np.float32)
    large_in = (t((rng.standard_normal((n_l, k_l)) * 4.0).astype(np.float32)),
                t(np.full(n_l, -1e30, np.float32)),
                t(assign_l.astype(np.int32)),
                t(rng.permutation(n_l).astype(np.int32)), t(sizes_l),
                torch.tensor(np.log(n_l - 1.0 + 10.0), dtype=torch.float32,
                             device=dev))
    cases += [main_in, large_in]

    def outputs(lib):
        got = []
        for zc, auxc, ac, pc, s0, ld in cases:
            sizes = s0.clone()
            tgt = torch.full((vecflow_probe.n_batches(pc.shape[0]),
                              vecflow_probe.BATCH), -7.0, device=dev)
            info = torch.zeros((1,), dtype=torch.int32, device=dev)
            vecflow(lib, zc, auxc, ac, pc, sizes, tgt, info, ld)
            torch.cuda.synchronize()
            got += [tgt, sizes, info]
        return got

    want = outputs(libs["k5_tree"])
    for name, lib in libs.items():
        if not same(outputs(lib), want):
            raise SystemExit(f"{name} disagrees with the tree")
        print(f"  {name}: outputs == tree ({len(cases)} runs)")

    res = {name: {} for name in ("k1_yardstick", *libs)}
    for _ in range(args.rounds):
        for name in res:
            for shape, (zc, auxc, ac, pc, s0, ld), reps in (
                    ("5000x256", main_in, 21), ("131072x128", large_in, 7)):
                n = pc.shape[0]
                buf = iter([s0.clone() for _ in range(reps)])
                info = torch.empty((4,), dtype=torch.int32, device=dev)
                tgt_l = torch.empty((n,), dtype=torch.int32, device=dev)
                tgt_v = torch.empty((vecflow_probe.n_batches(n),
                                     vecflow_probe.BATCH), device=dev)

                def once(name=name, zc=zc, auxc=auxc, ac=ac, pc=pc, ld=ld):
                    if name == "k1_yardstick":
                        seg(libs["k5_tree"], zc[:pc.shape[0]], auxc, ac, pc,
                            next(buf), tgt_l, info, 0, ld)
                    else:
                        vecflow(libs[name], zc, auxc, ac, pc, next(buf),
                                tgt_v, info, ld)

                res[name].setdefault(shape, []).append(cuda_ms(once, reps))
    return res


def write_sass(libs_dir, dest):
    """cuobjdump -sass of every variant's objects into `dest`, one file
    per object: <variant>_<source>.sass."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    os.makedirs(dest, exist_ok=True)
    for path in sorted(libs_dir.glob("*/*.o")):
        text = subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True).stdout
        (Path(dest) / f"{path.parent.name}_{path.stem}.sass").write_text(text)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", help="also write the times to this file")
    ap.add_argument("--only", default="step,k4,k2",
                    help="which A/Bs to run: step, k4, k2, k6, k5 "
                         "(comma-separated)")
    ap.add_argument("--sass", help="write every variant's SASS into this "
                                   "directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_gibbs_step: no CUDA device")
    dev = "cuda"
    print(card())
    runs = {"step": run_step, "k4": run_k4, "k2": run_k2, "k6": run_k6,
            "k5": run_k5}
    res = {}
    work = Path(tempfile.mkdtemp(prefix="ab_gibbs_step_"))
    try:
        for key in args.only.split(","):
            (work / key).mkdir()
            for name, r in runs[key](args, dev, work / key).items():
                res.setdefault(name, {}).update(r)  # k1_yardstick: k6 and k5
            if args.sass:
                write_sass(work / key, args.sass)
        print(f"median ms per launch, one value a round ({card()}):")
        for name, r in res.items():
            print(f"  {name:17s} " + "  ".join(
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
