"""Input/output: data loading, run configuration, result files, reporting
(counterpart of bnpc_tpu/io.py).

File contracts mirror the reference exactly (libs/dpmmIO.py): the same
separator/header sniffing on input, and the same args.txt / errors.txt /
assignment.txt / genotypes_*.tsv output-file formats, so downstream tooling
built for the reference keeps working. Host-side numpy and pandas, apart
from the estimators that `infer_results` calls on `device`.
"""

from __future__ import annotations

import os
import warnings
from datetime import timedelta
from string import ascii_uppercase

import numpy as np
import pandas as pd

from bnpc_tpu_torch import diagnostics, estimators

_VALID_TOKENS = (0.0, 1.0, 2.0, 3.0)


# ---------------------------------------------------------------------------
# Input (libs/dpmmIO.py:27-112)
# ---------------------------------------------------------------------------


def _sniff_separator(first_line: str) -> str:
    tabs, commas, spaces = (first_line.count(c) for c in ("\t", ",", " "))
    if tabs > spaces and tabs > commas:
        return "\t"
    if commas > spaces:
        return ","
    return " "


def _is_data_token(tok: str) -> bool:
    try:
        return float(tok) in _VALID_TOKENS
    except ValueError:
        return tok == " "


def _fast_matrix(in_file, sep: str, width: int):
    """A plain numeric matrix parsed at C speed (np.fromstring a row;
    pandas' parser takes minutes on a mutations x 10^6-cells file), or
    None where the pandas path must decide: a row that does not parse to
    its end (numpy warns instead of raising), a row of another width than
    the first line's `width` fields, or a finite value outside
    {0, 1, 2, 3} (a " " cell parses to -1.0 here, NaN in pandas)."""
    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            with open(in_file) as fh:
                for line in fh:
                    if line.strip():
                        rows.append(np.fromstring(
                            line, dtype=np.float64, sep=sep.strip() or " "))
        except (ValueError, DeprecationWarning):
            return None
    if any(r.size != width for r in rows):
        return None
    mat = np.vstack(rows)
    finite = mat[np.isfinite(mat)]
    if not np.isin(finite, _VALID_TOKENS).all():
        return None
    return mat


def load_data(in_file, transpose: bool = True, get_names: bool = False):
    """Load a mutation matrix; returns cells x mutations with NaN missing.

    Reproduces the reference's convention sniffing (libs/dpmmIO.py:27-98):
    separator from the first line; a header row / index column whenever a
    token is non-numeric or a number outside {0, 1, 2, 3}; the matrix is
    transposed by default (input files are mutations x cells); 3 -> NaN
    (missing), 2 -> 1 (homozygous -> heterozygous). A plain numeric file
    takes the fast parser (:func:`_fast_matrix`) when its result passes the
    checks there, else the pandas path.
    """
    with open(in_file) as fh:
        head = [fh.readline().strip() for _ in range(5)]
    head = [ln for ln in head if ln]
    sep = _sniff_separator(head[0])

    header_row = any(
        not _is_data_token(tok) for tok in head[0].split(sep) if tok != " "
    )
    body = head[1:] if header_row else head
    index_col = any(
        not _is_data_token(ln.split(sep)[0]) for ln in body
        if ln.split(sep)[0] != " "
    )

    if not header_row and not index_col:
        mat = _fast_matrix(in_file, sep, len(head[0].split(sep)))
        if mat is not None:
            if transpose:
                mat = mat.T
            mat[mat == 3] = np.nan
            mat[mat == 2] = 1
            if get_names:
                return mat, (np.arange(mat.shape[0]),
                             np.arange(mat.shape[1]))
            return mat

    df = pd.read_csv(
        in_file, sep=sep,
        index_col=0 if index_col else None,
        header=0 if header_row else None,
        na_values=[3, " "],
    ).astype(float)

    if transpose:
        df = df.T
    df = df.replace(3, np.nan).replace(2, 1)

    if get_names:
        return df.values, (df.index.values, df.columns.values)
    return df.values


def load_assignment_txt(path) -> list[int]:
    """Parse an assignment vector from either a plain space-separated file or
    this framework's / the reference's assignment.txt (libs/dpmmIO.py:101-112)."""
    try:
        df = pd.read_csv(path, sep="\t", index_col=False)
        tokens = str(df.at[0, "Assignment"]).strip().split(" ")
    except (ValueError, KeyError):
        with open(path) as fh:
            tokens = fh.read().strip().split(" ")
    return [int(t) for t in tokens if t]


def process_sim_folder(args, suffix: str = "") -> None:
    """Simulation-folder convention wiring (libs/dpmmIO.py:119-154):
    auto-discover data.csv / attachments.txt / data_raw.csv / tree*.gv."""
    if not os.path.isdir(args.input):
        sibling_raw = os.path.join(os.path.dirname(args.input), "data_raw.csv")
        if os.path.exists(sibling_raw) and not args.true_data:
            args.true_data = sibling_raw
        return

    in_dir = args.input
    args.input = os.path.join(in_dir, f"data{suffix}.csv")
    if getattr(args, "transpose", True):
        args.true_clusters = os.path.join(in_dir, "attachments.txt")

    raw = os.path.join(in_dir, "data_raw.csv")
    if os.path.exists(raw):
        args.true_data = raw

    for tree_name in (
        f"tree_w_errors{suffix}.gv",
        f"tree_w_cells_w_errors{suffix}.gv",
        f"tree_w_cells{suffix}.gv",
        f"tree{suffix}.gv",
    ):
        cand = os.path.join(in_dir, tree_name)
        if os.path.exists(cand):
            args.tree = cand
            break


def get_mcmc_termination(args):
    """(run_var, run_str) — steps / runtime / lugsail (libs/dpmmIO.py:157-169)."""
    if args.runtime > 0:
        end = args.time[0] + timedelta(minutes=args.runtime)
        bi = args.time[0] + args.burn_in * timedelta(minutes=args.runtime)
        return (end, bi), f"for {args.runtime} mins"
    if args.lugsail > 0:
        return (float(args.lugsail), 0), f"until PSRF < {args.lugsail:.4f}"
    return (int(args.steps), int(args.steps * args.burn_in)), \
        f"for {args.steps} steps"


def get_out_dir(args, prefix: str = "") -> str:
    """Output directory, default <data_dir>/BnpC_<timestamp> with collision
    suffixing (libs/dpmmIO.py:172-192)."""
    if args.output:
        if any(args.output.endswith(s) for s in (".txt", ".gv", ".csv")):
            out_dir = os.path.dirname(args.output)
        else:
            out_dir = args.output
    else:
        stamp = f"BnpC_{args.time[0]:%Y%m%d_%H:%M:%S}{prefix}"
        out_dir = os.path.join(os.path.dirname(args.input), stamp)
        base, i = out_dir, 1
        while os.path.exists(out_dir):
            out_dir = f"{base}_{i}"
            i += 1
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


# ---------------------------------------------------------------------------
# Inference dispatch (libs/dpmmIO.py:199-225)
# ---------------------------------------------------------------------------


def infer_results(args, results: list[dict], data: np.ndarray,
                  device="cuda"):
    """(inferred, PSRF, per-chain step counts); the posterior estimator's
    device work runs on `device`.

    The reference's _infer_results writes PSRF/steps INTO args as a side
    effect (libs/dpmmIO.py:199-202), which couples generate_output's call
    order to save_config. Here they are returned; the caller decides where
    they land (cli.generate_output puts them on args for args.txt parity).
    """
    psrf = diagnostics.lugsail_psrf(
        [(r["ML"], r["burn_in"]) for r in results]
    )
    steps = [r["ML"].size for r in results]

    estimators_list = (
        [args.estimator] if isinstance(args.estimator, str) else args.estimator
    )
    inferred = {
        i: {} for i in (range(args.chains) if args.single_chains else [0])
    }
    for est in estimators_list:
        if est == "posterior":
            per_chain = estimators.latents_posterior(
                results, data, args.single_chains, device=device
            )
        else:
            per_chain = estimators.latents_point(
                results, est, data, args.single_chains
            )
        for i, latents in enumerate(per_chain):
            inferred[i][est] = latents

    if not args.single_chains:
        inferred["mean"] = inferred.pop(0)
    return inferred, psrf, steps


# ---------------------------------------------------------------------------
# Output files (libs/dpmmIO.py:422-542)
# ---------------------------------------------------------------------------


def save_run(inferred, args, out_dir, names) -> None:
    save_config(args, out_dir)
    save_errors(inferred, args, out_dir)
    save_assignments(inferred, args, out_dir)
    save_geno(inferred, out_dir, names[1])


def save_config(args, out_dir, out_file: str = "args.txt") -> None:
    cfg = dict(vars(args)) if not isinstance(args, dict) else dict(args)
    cfg["time"] = [f"{t:%Y%m%d_%H:%M:%S}" for t in cfg["time"]]

    # Only the relevant error fields are persisted (libs/dpmmIO.py:437-447).
    if cfg.get("falseNegative", -1) > 0:
        cfg.pop("falseNegative_mean", None)
        cfg.pop("falseNegative_std", None)
    else:
        cfg.pop("falseNegative", None)
    if cfg.get("falsePositive", -1) > 0:
        cfg.pop("falsePositive_mean", None)
        cfg.pop("falsePositive_std", None)
    else:
        cfg.pop("falsePositive", None)

    with open(os.path.join(out_dir, out_file), "w") as fh:
        for key, val in cfg.items():
            fh.write(f"{key}: {val}\n")


def _iter_latents(inferred):
    for chain, per_est in inferred.items():
        for est, latents in per_est.items():
            yield chain, est, latents


def save_errors(inferred, args, out_dir) -> None:
    rows = []
    for chain, est, lat in _iter_latents(inferred):
        if est == "posterior":
            fn_model = f"{lat['FN'][0]:.4f}+-{lat['FN'][1]:.4f}"
            fp_model = f"{lat['FP'][0]:.8f}+-{lat['FP'][1]:.8f}"
        else:
            fn_model = round(lat["FN"], 4)
            fp_model = round(lat["FP"], 8)
        rows.append([
            chain, est, fn_model, round(lat["FN_geno"], 4),
            fp_model, round(lat["FP_geno"], 8),
        ])
    df = pd.DataFrame(
        rows,
        columns=["chain", "estimator", "FN_model", "FN_data",
                 "FP_model", "FP_data"],
    )
    df.to_csv(os.path.join(out_dir, "errors.txt"), index=False, sep="\t")


def save_assignments(inferred, args, out_dir) -> None:
    rows = []
    for chain, est, lat in _iter_latents(inferred):
        assign_str = " ".join(str(int(a)) for a in lat["assignment"])
        rows.append([chain, est, assign_str])
    df = pd.DataFrame(rows, columns=["chain", "estimator", "Assignment"])
    df.to_csv(os.path.join(out_dir, "assignment.txt"), index=False, sep="\t")


def _csv_field(text: str) -> str:
    """`text` as pandas' writer (Python's csv module, QUOTE_MINIMAL, tab
    separated) puts it in a row of more than one field."""
    if any(c in text for c in '\t"\r\n'):
        return '"' + text.replace('"', '""') + '"'
    return text


def _write_tsv(frame: pd.DataFrame, path) -> None:
    """Writes the bytes of `frame.to_csv(path, sep="\\t")` for a numeric
    frame of one dtype with int or string row labels, ~20 times faster:
    pandas formats every value with numpy's `astype(str)` (~1-3 us a value,
    minutes for a 200 x 131,072 table), here each distinct value (by its
    bits, so -0.0 stays apart from 0.0) is formatted once and the rows are
    joined from that table. The header is pandas' own."""
    values = frame.to_numpy()
    floats = values.dtype.kind == "f"
    bits = np.dtype(f"i{values.itemsize}")
    codes, uniq = pd.factorize(
        values.reshape(-1).view(bits) if floats else values.reshape(-1))
    if floats:
        uniq = uniq.view(values.dtype)
    text = uniq.astype(str).astype(object)
    if floats:
        text[np.isnan(uniq)] = ""  # to_csv's na_rep
    codes = codes.reshape(values.shape)
    end = os.linesep
    with open(path, "w", newline="", encoding="utf-8") as fh:
        fh.write(frame.iloc[:0].to_csv(sep="\t"))
        for label, row in zip(frame.index, codes):
            fh.write(_csv_field(str(label)) + "\t"
                     + "\t".join(text[row].tolist()) + end)


def save_geno(inferred, out_dir, names=None) -> None:
    if names is None:
        names = np.array([])
    for chain, est, lat in _iter_latents(inferred):
        geno = lat["genotypes"]
        if np.size(names) == geno.index.size:
            geno.index = names

        chain_str = f"{chain:0>2}"
        if bool((geno.round() == geno).all().all()):
            _write_tsv(
                geno.astype(int),
                os.path.join(out_dir, f"genotypes_{est}_{chain_str}.tsv"),
            )
        else:
            _write_tsv(
                geno.round(4),
                os.path.join(out_dir, f"genotypes_cont_{est}_{chain_str}.tsv"),
            )
            _write_tsv(
                geno.round().astype(int),
                os.path.join(out_dir, f"genotypes_{est}_{chain_str}.tsv"),
            )


def _metric_df(inferred, true_cl, colname, score_fn) -> pd.DataFrame:
    rows = [
        [chain, est, score_fn(lat["assignment"], true_cl)]
        for chain, est, lat in _iter_latents(inferred)
    ]
    return pd.DataFrame(rows, columns=["chain", "estimator", colname])


def save_v_measure(inferred, true_cl, out_dir) -> None:
    _metric_df(inferred, true_cl, "V-measure", estimators.v_measure).to_csv(
        os.path.join(out_dir, "V_measure.txt"), index=False, sep="\t"
    )


def save_ari(inferred, true_cl, out_dir) -> None:
    _metric_df(inferred, true_cl, "ARI", estimators.ari).to_csv(
        os.path.join(out_dir, "ARI.txt"), index=False, sep="\t"
    )


def save_hamming_dist(inferred, true_data, out_dir) -> None:
    rows = [
        [chain, est,
         1 - estimators.hamming_dist(lat["genotypes"], true_data)
         / true_data.size]
        for chain, est, lat in _iter_latents(inferred)
    ]
    df = pd.DataFrame(
        rows, columns=["chain", "estimator", "1 - norm Hamming distance"]
    )
    df.to_csv(os.path.join(out_dir, "hammingDist.txt"), index=False, sep="\t")


# ---------------------------------------------------------------------------
# Stdout reporting (libs/dpmmIO.py:310-415)
# ---------------------------------------------------------------------------


def show_mcmc_summary(args, results) -> None:
    total = args.time[1] - args.time[0]
    per_step = total / results[0]["ML"].size
    print(
        f"\nClustering time:\t{total}\t"
        f"({per_step.total_seconds():.2f} secs. per MCMC step)"
        f"\tLugsail PSRF:\t\t{args.PSRF:.5f}\n"
    )


def show_mh_acceptance(counter, name, tab_no: int = 2) -> None:
    total = counter.sum()
    rate = counter[0] / total if total else np.nan
    print("\t\t\t{}:{}{:.2f}".format(name, "\t" * tab_no, rate))


def show_assignments(inferred, names=None) -> None:
    for chain, est, lat in _iter_latents(inferred):
        cl_no = np.unique(lat["assignment"]).size
        print(f"Chain {chain:0>2} - {est} clusters\t(#{cl_no}):")
        show_assignment(lat["assignment"], names)


def show_assignment(assignment, names=None) -> None:
    groups: dict[int, list[int]] = {}
    for cell, cl in enumerate(assignment):
        groups.setdefault(int(cl), []).append(cell)

    print_cells = all(len(v) < 30 for v in groups.values())
    if not print_cells:
        print(f"\t{len(groups)} clusters\n")

    for i, (cl, items) in enumerate(groups.items()):
        label = ascii_uppercase[i % 26] * (i // 26 + 1)
        if print_cells:
            shown = (
                names[items] if names is not None and np.size(names) > 0
                else items
            )
            print(f"\t{label}: " + ", ".join(f"{it: >4}" for it in shown))
        else:
            print(f"\t{label}: {len(items)} items")


def show_latents(inferred) -> None:
    for chain, est, lat in _iter_latents(inferred):
        print(
            f"\nInferred latent variables\t--\tchain {chain:0>2} - {est}"
            f"\n\tCRP a_0:\t{latent_str(lat['a'])}"
        )
        for error in ("FP", "FN"):
            if lat[error]:
                dec, dtype = (1, "E") if error == "FP" else (3, "f")
                model = latent_str(lat[error], dec, dtype)
                geno = latent_str(lat[f"{error}_geno"], dec, dtype)
                print(f"\t{error} (model|genotypes): {model}\t|\t{geno}")


def latent_str(latent_var, dec: int = 1, dtype: str = "f") -> str:
    if latent_var is None:
        return "not inferred"
    fmt = "{:." + str(int(dec)) + dtype + "}"
    if isinstance(latent_var, (tuple, list, np.ndarray)):
        return (fmt + " " * (dec - 1) + " +- " + fmt).format(*latent_var)
    return fmt.format(latent_var)
