#!/usr/bin/env python3
"""The genotype-table writer of the port's io against pandas' to_csv.

    python3 scripts/time_table_writer.py [--cells 16384] [--muts 200]

Builds a muts x cells table of random values rounded to 4 decimals (a
posterior mean genotype table) and its rounded int copy, writes each with
`bnpc_tpu_torch.io._write_tsv` and with `DataFrame.to_csv(sep="\\t")`,
checks that the bytes are equal, and prints the seconds of each. Host
only: no device is used.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bnpc_tpu_torch import io  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", type=int, default=16384)
    p.add_argument("--muts", type=int, default=200)
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    cont = pd.DataFrame(rng.random((args.muts, args.cells)).round(4))
    tables = {"float": cont, "int": cont.round().astype(int)}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, frame in tables.items():
            secs = {}
            for name, write in (("pandas", lambda f, p: f.to_csv(p, sep="\t")),
                                ("port", io._write_tsv)):
                path = os.path.join(tmp, f"{name}.tsv")
                t0 = time.perf_counter()
                write(frame, path)
                secs[name] = time.perf_counter() - t0
            with open(os.path.join(tmp, "pandas.tsv"), "rb") as a, \
                    open(os.path.join(tmp, "port.tsv"), "rb") as b:
                if a.read() != b.read():
                    raise SystemExit(f"{kind}: the bytes differ")
            print(f"{kind} {args.muts} x {args.cells}: to_csv "
                  f"{secs['pandas']:.4f} s, _write_tsv {secs['port']:.4f} s "
                  "(same bytes)")


if __name__ == "__main__":
    main()
