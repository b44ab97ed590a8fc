#!/usr/bin/env python3
"""CLI entry point of the PyTorch / CUDA port (reference: run_BnpC.py)."""

from bnpc_tpu_torch.cli import entry

if __name__ == "__main__":
    entry()
