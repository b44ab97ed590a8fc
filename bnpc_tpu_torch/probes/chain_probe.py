"""Measurement: the latency of the links of the serial Gibbs chain, and the
bound it puts under the Gibbs and restricted-scan kernels.

Not a counterpart of a TPU kernel and not on the sampler's path. The kernel
(csrc/chain_probe.cu) times, on one warp, long chains of dependent
instructions with ``clock64()``: a warp shuffle, a shuffle + ``fmaxf`` (one
round of a shuffle reduction), ``redux.sync``, a ballot, the accurate
``logf``, a shared-memory load whose address is the previous load's result,
a compare + select, a float add, an integer ALU pair, an integer compare +
select, and the restricted scan's link in two forms; and the SM clock during
the run
(cycles over ``%globaltimer`` nanoseconds).

The per-cell step of the Gibbs kernels is serial by definition: the next
cell's logits need this cell's size update. The shortest dependent chain
the algorithm allows per cell is

    select (the changed weight) -> add (its logit) -> max over the row
    -> first index holding the max -> select (the target)

that is two compare + selects, one float add and two warp reductions
(`argmax_chain_cycles`). For the restricted 2-way scan read as written it is
a table load-use, a float add, a compare + select and an integer add
(`table_scan_chain_cycles`); but only the count depends on the cell before,
and where the table is monotone each cell's comparison is a threshold on the
count known ahead (csrc/rg_scan.cu), so the shortest chain is an integer
compare and the add of its outcome, taken as a subtract and the add of its
sign bit because a predicated add is more than twice as long
(`scan_chain_cycles`, the measured `scan_link`; `cmp_pred_add` beside it).
``cells x cycles / clock`` is the least time a sweep can take on the card
(`chain_bound_ms`), whatever the kernel does around the chain; the bytes
bound of a roofline is orders of magnitude below it.

    python -m bnpc_tpu_torch.probes.chain_probe

prints the cycles per link, the clock, and the per-cell chains. It needs
a CUDA device: there is nothing to measure on a CPU.
"""

from __future__ import annotations

import torch

from bnpc_tpu_torch.ops import _build
from bnpc_tpu_torch.probes import card, parse_args

# The kernel's chains, in the order of its output.
CHAINS = ("shfl", "shfl_fmax", "redux_max", "ballot_test", "logf_fadd",
          "smem_load_use", "cmp_select", "fadd", "xor_add", "icmp_select",
          "cmp_pred_add", "scan_link")
UNROLL = 16
ITERS = 1024


def argmax_chain_cycles(cycles: dict) -> float:
    """Cycles of the shortest per-cell chain of the sequential Gibbs step:
    select, add, max reduction, first-index reduction, select."""
    return (2 * cycles["redux_max"] + cycles["fadd"]
            + 2 * cycles["cmp_select"])


def table_scan_chain_cycles(cycles: dict) -> float:
    """Cycles of the restricted 2-way scan's per-cell chain as the
    recurrence is written: table load-use, add, compare + select, integer
    add."""
    return (cycles["smem_load_use"] + cycles["fadd"] + cycles["cmp_select"]
            + cycles["iadd"])


def scan_chain_cycles(cycles: dict) -> float:
    """Cycles of the shortest per-cell chain of the restricted 2-way scan:
    with each cell's threshold known ahead, a subtract and the add of its
    sign bit (the kernel's link, measured whole)."""
    return cycles["scan_link"]


def chain_bound_ms(cells: int, cycles_per_cell: float,
                   clock_ghz: float) -> float:
    """Least milliseconds for `cells` serial cells of that chain."""
    return cells * cycles_per_cell / (clock_ghz * 1e9) * 1e3


def measure(device) -> dict:
    """Run the kernel; cycles per link of every chain, the derived
    ``logf`` (logf_fadd - fadd) and ``iadd`` (xor_add / 2), and
    ``clock_ghz``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_probe: needs a CUDA device, got {dev}")
    seed = torch.tensor([12.5, 1.0, 3.0, 5.0], device=dev)
    out = torch.zeros((2 * len(CHAINS) + 2,), dtype=torch.int64, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):  # the first run warms the instruction cache
        rc = lib.bnpc_chain_probe(seed.data_ptr(), out.data_ptr(), ITERS,
                                  stream)
        _build.check_launch(rc, "bnpc_chain_probe")
    raw = out.tolist()
    links = ITERS * UNROLL
    cycles = {name: raw[2 * k] / links for k, name in enumerate(CHAINS)}
    cycles["logf"] = cycles["logf_fadd"] - cycles["fadd"]
    cycles["iadd"] = cycles["xor_add"] / 2
    cycles["clock_ghz"] = raw[-2] / raw[-1]
    return cycles


def main(argv=None) -> dict:
    args = parse_args(argv, "latency of the Gibbs chain's links")
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("chain_probe: needs a CUDA device (there is "
                         "nothing to measure on a CPU)")
    cycles = measure(dev)
    clock = cycles["clock_ghz"]
    print(f"chain_probe ({card()}; SM clock {clock:.4f} GHz during the run;"
          f" {ITERS * UNROLL} dependent links a chain):", flush=True)
    for name in (*CHAINS, "logf", "iadd"):
        print(f"  {name}: {cycles[name]:.2f} cycles "
              f"({cycles[name] / clock:.2f} ns)", flush=True)
    res = dict(cycles)
    res["argmax_chain_cycles"] = argmax_chain_cycles(cycles)
    res["scan_chain_cycles"] = scan_chain_cycles(cycles)
    res["table_scan_chain_cycles"] = table_scan_chain_cycles(cycles)
    for name in ("argmax_chain_cycles", "scan_chain_cycles",
                 "table_scan_chain_cycles"):
        print(f"  {name}: {res[name]:.1f} cycles a cell "
              f"({res[name] / clock / 1e3:.4f} us)", flush=True)
    return res


if __name__ == "__main__":
    main()
