"""Process-group set-up (counterpart of bnpc_tpu/parallel/multihost.py).

One process per rank under torch.distributed: ``initialize`` wraps
``dist.init_process_group`` with its address, world size and rank from the
arguments or, failing them, from torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, and LOCAL_RANK for the device). The backend
is chosen explicitly and printed: nccl when every local rank has a CUDA
device of its own, gloo when ranks share a card or run on the CPU. A
collective that waits longer than TIMEOUT_S fails the run instead of
hanging it (a rank that skipped a collective its group runs).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0


def choose_backend(device: str, local_ranks: int) -> str:
    """nccl iff the ranks sample on CUDA and each local rank has a card of
    its own; else gloo (NCCL refuses two ranks on one device)."""
    if device.startswith("cuda") and torch.cuda.is_available() \
            and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: str = "cuda") -> bool:
    """Join the process group; returns True when running multi-process,
    False (and does nothing) for a single process. Explicit arguments win
    over the environment. On CUDA, rank r's device is cuda:(LOCAL_RANK %
    device count), set before the group is made."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator address "
                         "and this process's rank (or MASTER_ADDR / RANK)")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(device, local_ranks)
    if device.startswith("cuda") and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=TIMEOUT_S))
    if process_id == 0:
        print(f"bnpc_tpu_torch: {num_processes} ranks, backend {backend}",
              flush=True)
    return True
