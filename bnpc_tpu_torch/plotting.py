"""Result plots: traces, genotype clustermap, posterior similarity, trees
(counterpart of bnpc_tpu/plotting.py; reference libs/plotting.py).

Same artifact set (Traces.pdf, genoCluster_*.pdf, Posterior_similarity_*.pdf,
colored tree .gv), rendered with matplotlib/seaborn on the host. Importing
this module imports both, so the CLI imports it only when plots are asked
for (and checks for both before sampling starts).
"""

from __future__ import annotations

import os
import re
from itertools import cycle

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import seaborn as sns  # noqa: E402
from matplotlib.gridspec import GridSpec  # noqa: E402
from scipy.cluster.hierarchy import dendrogram, linkage  # noqa: E402

from bnpc_tpu_torch import estimators  # noqa: E402

COLORS = [
    "#1F78B4", "#33A02C", "#E31A1C", "#FF7F00", "#6A3D9A",
    "#A6CEE3", "#B2DF8A", "#FB9A99", "#FDBF6F", "#CAB2D6",
    "#62A3CB", "#72BF5B", "#EF5A5A", "#FE9F37", "#9A77B8",
    "#FFFF99", "#B15928",
]
LABEL_FONTSIZE = 16


def _color_cycle(n, cmap="gist_rainbow", scale=0.85):
    cm = plt.get_cmap(cmap)
    cols = (cm(np.arange(0, 1, 1 / max(n, 1)))[:, :3] * 255 * scale)
    cols = np.clip(cols, 0, 255).astype(int)
    hexes = ["#{:02x}{:02x}{:02x}".format(*c) for c in cols]
    half = len(hexes) // 2
    interleaved = [
        h for pair in zip(hexes[:half], hexes[half:]) for h in pair
    ] or hexes
    return cycle(interleaved)


def _chain_color(i, extra_cycle=[None]):
    if i < len(COLORS):
        return COLORS[i]
    if extra_cycle[0] is None:
        extra_cycle[0] = _color_cycle(10)
    return next(extra_cycle[0])


def _cluster_col_order(assignment):
    """Cells ordered by decreasing cluster size (libs/plotting.py:53-62)."""
    assignment = np.asarray(assignment)
    clusters, counts = np.unique(assignment, return_counts=True)
    order = []
    for ci in np.argsort(counts)[::-1]:
        order.extend(np.nonzero(assignment == clusters[ci])[0].tolist())
    return np.array(order, dtype=int)


# ---------------------------------------------------------------------------
# Trace plot (libs/plotting.py:183-292) -> Traces.pdf
# ---------------------------------------------------------------------------


def plot_traces(results, out_file=None):
    has_errors = "FP" in results[0]
    has_psrf = "PSRF" in results[0]
    no_rows = 6 + 2 * has_errors + has_psrf

    fig = plt.figure(figsize=(10, no_rows * 2))
    gs = GridSpec(no_rows, 1)
    ax = {
        0: fig.add_subplot(gs[0, 0]),
        1: fig.add_subplot(gs[1, 0]),
        2: fig.add_subplot(gs[2:4, 0]),
        3: fig.add_subplot(gs[4:6, 0]),
    }
    if has_errors:
        ax[4] = fig.add_subplot(gs[6, 0])
        ax[5] = fig.add_subplot(gs[7, 0])

    for i, res in enumerate(results):
        _add_chain_traces(res, ax, _chain_color(i))

    step_no = results[0]["ML"].size + 1
    if has_psrf:
        axp = fig.add_subplot(gs[no_rows - 1, 0])
        ax[6] = axp
        vals = np.full(step_no, np.nan)
        for step_i, psrf_i in results[0]["PSRF"]:
            if step_i < step_no:
                vals[step_i] = psrf_i
        axp.plot(np.arange(step_no), vals, "rx")
        axp.set_ylabel("PSRF", fontsize=LABEL_FONTSIZE)
        axp.axhline(1, ls="-", c="black")
        axp.axhline(results[0]["PSRF_cutoff"], ls=":", c="red")

    tick_dist = max(int(np.floor(step_no // 10 / 100) * 100), 1)
    ticks = [tick_dist * i for i in range(11)]
    last = max(ax)
    for ax_id, a in ax.items():
        a.set_xlim(-step_no * 0.05, step_no * 1.05)
        a.set_xticks(ticks)
        if ax_id == last:
            a.set_xticklabels([str(t) for t in ticks])
            a.set_xlabel("MCMC steps", fontsize=LABEL_FONTSIZE)
        else:
            a.set_xticklabels([])

    _save_fig(fig, out_file)


def _add_chain_traces(res, ax, color, alpha=0.4, std_fkt=2.576):
    bi = res["burn_in"]

    a_mean, a_std = estimators._posterior_avg(res["DP_alpha"][bi:])
    ax[0].plot(res["DP_alpha"], color, alpha=alpha)
    ax[0].set_ylabel("DPMM\nalpha", fontsize=LABEL_FONTSIZE)
    ax[0].axhline(a_mean, ls="--", c=color)
    ax[0].set_ylim(a_mean - std_fkt * a_std, a_mean + std_fkt * a_std)

    cl = [np.unique(row).size for row in res["assignments"]]
    cl_mean, cl_std = estimators._posterior_avg(cl[bi:])
    ax[1].plot(cl, color, alpha=alpha)
    ax[1].axhline(cl_mean, ls="--", c=color)
    if cl_std > 0:
        ax[1].set_ylim(cl_mean - std_fkt * cl_std, cl_mean + std_fkt * cl_std)
    ax[1].set_ylabel("Cluster\nnumber", fontsize=LABEL_FONTSIZE)

    ax[2].plot(res["MAP"], color, alpha=alpha)
    ax[3].plot(res["ML"], color, alpha=alpha)
    ax[2].set_ylabel("Log a posteriori", fontsize=LABEL_FONTSIZE)
    ax[3].set_ylabel("Log likelihood", fontsize=LABEL_FONTSIZE)

    if 4 in ax:
        fn_mean, _ = estimators._posterior_avg(res["FN"][bi:])
        ax[4].plot(np.round(res["FN"], 4), color, alpha=alpha)
        ax[4].set_ylabel("FN error", fontsize=LABEL_FONTSIZE)
        ax[4].axhline(fn_mean, ls="--", c=color)
    if 5 in ax:
        fp_mean, _ = estimators._posterior_avg(res["FP"][bi:])
        ax[5].plot(np.round(res["FP"], 4), color, alpha=alpha)
        ax[5].set_ylabel("FP error", fontsize=LABEL_FONTSIZE)
        ax[5].axhline(fp_mean, ls="--", c=color)

    if bi > 0:
        for a in ax.values():
            a.axvline(bi, c=color)


# ---------------------------------------------------------------------------
# Genotype clustermap (libs/plotting.py:65-180) -> genoCluster_*.pdf
# ---------------------------------------------------------------------------


def plot_genotypes(data_in: pd.DataFrame, data_raw_in=None, out_file=None,
                   assignment=None, row_cl=True):
    # Reference sizing (libs/plotting.py:70-71), capped: at thousands of
    # cells the uncapped formula yields a 500-inch canvas that takes
    # minutes to render and is unreadable anyway.
    height = min(max(int(data_in.shape[0] // 5), 2), 60)
    width = min(max(int(data_in.shape[1] // 10), 4), 120)

    have_raw = data_raw_in is not None
    x_labels = np.asarray(data_in.columns)
    col_sel = np.arange(data_in.shape[1])
    col_colors = None
    if assignment is not None and len(assignment) > 0:
        if have_raw:
            x_labels = np.asarray(data_raw_in.columns)
        col_sel = _cluster_col_order(assignment)
        clusters, cl_cnt = np.unique(assignment, return_counts=True)
        extra = _color_cycle(max(clusters.size - len(COLORS), 1))
        col_map = {}
        for i, cl in enumerate(clusters[np.argsort(cl_cnt)[::-1]]):
            col_map[cl] = COLORS[i] if i < len(COLORS) else next(extra)
        col_colors = np.array(
            [col_map[c] for c in np.asarray(assignment)[col_sel]],
            dtype="<U7",
        )

    # Very wide matrices: subsample columns evenly AFTER cluster ordering
    # (preserves per-cluster proportions and block structure). At tens of
    # thousands of cells the capped canvas leaves multiple cells per
    # rendered pixel anyway, while the uncapped pcolormesh costs ~10 min
    # of render time at n = 50,000. Documented deviation, same spirit as
    # the canvas cap above.
    max_cols = 4096
    if col_sel.size > max_cols:
        keep = np.unique(
            np.linspace(0, col_sel.size - 1, max_cols).astype(int)
        )
        col_sel = col_sel[keep]
        if col_colors is not None:
            col_colors = col_colors[keep]

    # One positional take per frame: label-based pandas column selection
    # fragments the block manager at 50k columns (~19 s of consolidate).
    disp_cols = np.arange(col_sel.size)
    data = pd.DataFrame(
        data_in.to_numpy()[:, col_sel], index=data_in.index,
        columns=disp_cols,
    )
    data_raw = (
        pd.DataFrame(data_raw_in.to_numpy()[:, col_sel],
                     index=data_raw_in.index, columns=disp_cols)
        if have_raw else pd.DataFrame()
    )
    x_labels = x_labels[col_sel]
    cluster_cols = (
        pd.Series(col_colors, name="clusters", index=disp_cols)
        if col_colors is not None else None
    )

    if row_cl and data.shape[0] > 2:
        z = linkage(data.fillna(3), "complete")
        row_order = dendrogram(z, no_plot=True)["leaves"]
        data = data.iloc[row_order]
        if not data_raw.empty:
            data_raw = data_raw.iloc[row_order]

    annot = False
    if not data_raw.empty and data_raw.size < 30_000:
        annot = pd.DataFrame(
            np.full(data_raw.shape, "", dtype=str),
            index=data.index, columns=data.columns,
        )
        annot[(data.round() == 0) & (data_raw == 1)] = "o"
        annot[(data.round() == 1) & (data_raw == 0)] = "x"
        annot[data_raw.isnull()] = "-"

    cmap = plt.get_cmap("Reds", 2)
    cmap.set_over("green")
    cmap.set_bad("grey")

    cm = sns.clustermap(
        data, annot=annot if annot is not False else None,
        square=False, vmin=0, vmax=1, cmap=cmap, fmt="",
        linewidths=0, linecolor="lightgray",
        col_colors=cluster_cols, col_cluster=False, row_cluster=False,
        figsize=(width, height),
        # Large matrices: store the mesh as an image instead of ~1M vector
        # quads — same rendered artifact at the used dpi, minutes faster to
        # write and orders of magnitude smaller on disk.
        rasterized=data.size > 30_000,
    )
    cm.cax.set_visible(False)
    cm.ax_row_dendrogram.set_visible(False)
    for side in ("top", "right", "bottom", "left"):
        cm.ax_heatmap.spines[side].set_visible(True)
    # Per-cell/mutation tick labels match the reference up to the point
    # where they cannot physically fit on the capped canvas.
    if data.shape[0] <= 600:
        cm.ax_heatmap.set_yticks(np.arange(0.5, data.shape[0], 1))
        cm.ax_heatmap.set_yticklabels(data.index, fontsize=8)
    if data.shape[1] <= 1500:
        cm.ax_heatmap.set_xticks(np.arange(0.5, data.shape[1], 1))
        cm.ax_heatmap.set_xticklabels(x_labels, rotation=90, fontsize=8)
    else:
        cm.ax_heatmap.set_xticks([])

    if not out_file:
        plt.show()
    else:
        dpi = 300 if data.shape[0] < 50 else (200 if data.shape[0] < 100 else 100)
        # Rasterized large plots: cap the image at ~8k px across — beyond
        # ~2 px per (subsampled) column the extra resolution only slows the
        # agg render and the PDF image write (~35 s at 12k px).
        if data.size > 30_000:
            dpi = min(dpi, max(40, 8000 // width))
        cm.savefig(out_file, dpi=dpi)
    plt.close("all")


# ---------------------------------------------------------------------------
# Posterior similarity heatmap (libs/plotting.py:295-323)
# ---------------------------------------------------------------------------


def plot_similarity(sim, out_file=None, attachments=None):
    fig, ax = plt.subplots(
        figsize=np.clip(np.array(sim.shape) * 0.3, 1, 50)
    )
    data = pd.DataFrame(sim)
    if attachments is not None:
        order = _cluster_col_order(attachments)
        data = data[order].reindex(order)

    sns.heatmap(
        data, ax=ax, annot=False, linewidths=0.5, square=True,
        linecolor="lightgray", cmap="OrRd",
        cbar_kws={"shrink": 0.5}, vmin=0, vmax=1,
    )
    ax.set_ylabel("Cell", fontsize=LABEL_FONTSIZE)
    ax.set_xlabel("Cell", fontsize=LABEL_FONTSIZE)
    ax.set_title("Pairwise Similarity Matrix", fontsize=LABEL_FONTSIZE)
    dpi = 300 if sim.shape[0] < 50 else (200 if sim.shape[0] < 100 else 100)
    _save_fig(fig, out_file, dpi=dpi)


# ---------------------------------------------------------------------------
# Tree coloring (libs/plotting.py:326-363)
# ---------------------------------------------------------------------------


def color_tree_nodes(tree_file, clusters, out_dir="", transpose=True,
                     prefix="colored"):
    with open(tree_file) as fh:
        gv_raw = fh.read().rstrip("}")

    if len(re.findall("circle", gv_raw)) > 1:
        pos = gv_raw.rfind("circle")
        gv_raw = gv_raw[:pos] + "square" + gv_raw[pos + 6:]

    clusters = [-1 if isinstance(c, tuple) else int(c) for c in clusters]
    palette = _color_cycle(np.unique(clusters).size)
    col = {c: next(palette) for c in np.unique(clusters)}
    col[-1] = "#ffffff"

    if transpose:
        for cell, cl in enumerate(clusters):
            gv_raw += f's{cell:02d} [fillcolor="{col[cl]}"];\n'
    else:
        for mut, cl in enumerate(clusters):
            gv_raw += f'{mut + 1} [fillcolor="{col[cl]}"];\n'
    gv_raw += "}"

    out_file = os.path.join(
        out_dir,
        os.path.basename(tree_file).replace(".gv", f"__{prefix}.gv"),
    )
    with open(out_file, "w") as fh:
        fh.write(gv_raw)

    try:
        from graphviz import render

        render("dot", "png", out_file)
    except Exception:
        pass
    return out_file


# ---------------------------------------------------------------------------
# Dispatchers used by the CLI (libs/dpmmIO.py:232-287)
# ---------------------------------------------------------------------------


def save_trace_plots(results, out_dir):
    plot_traces(results, os.path.join(out_dir, "Traces.pdf"))


def save_geno_plots(inferred, data_raw, out_dir, names):
    for chain, per_est in inferred.items():
        for est, lat in per_est.items():
            out_file = os.path.join(
                out_dir, f"genoCluster_{est}_{chain:0>2}.pdf"
            )
            df_obs = pd.DataFrame(
                data_raw, index=names[0], columns=names[1]
            ).T
            plot_genotypes(
                lat["genotypes"], df_obs,
                assignment=lat["assignment"], out_file=out_file,
            )


def save_tree_plots(tree, inferred, out_dir, transpose=True):
    for chain, per_est in inferred.items():
        for est, lat in per_est.items():
            color_tree_nodes(
                tree, lat["assignment"], out_dir, transpose,
                f"colored_{est}_{chain:0>2}",
            )


def save_similarity(args, inferred, results, out_dir):
    from bnpc_tpu_torch import io as _io

    attachments = (
        _io.load_assignment_txt(args.true_clusters)
        if args.true_clusters else None
    )

    def _sim_for(assignments):
        return estimators.coclustering_similarity(assignments, args.device)

    if args.single_chains:
        for i, res in enumerate(results):
            att = attachments
            if att is None:
                att = inferred.get(i, {}).get("posterior", {}) \
                    .get("assignment")
            sim = _sim_for(res["assignments"][res["burn_in"]:])
            np.fill_diagonal(sim, 1.0)
            plot_similarity(
                sim, os.path.join(out_dir, f"Posterior_similarity_{i:0>2}.pdf"),
                att,
            )
    else:
        assignments = np.concatenate(
            [r["assignments"][r["burn_in"]:] for r in results]
        )
        att = attachments
        if att is None:
            att = inferred.get("mean", {}).get("posterior", {}) \
                .get("assignment")
        sim = _sim_for(assignments)
        np.fill_diagonal(sim, 1.0)
        plot_similarity(
            sim, os.path.join(out_dir, "Posterior_similarity_mean.pdf"), att
        )


def _save_fig(fig, out_file, dpi=300):
    if not out_file:
        plt.show()
    else:
        fig.subplots_adjust(left=0.1, bottom=0.1, right=0.9, top=0.9)
        fig.savefig(out_file, dpi=dpi)
        plt.close(fig)
