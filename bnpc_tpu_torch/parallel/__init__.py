"""Multi-process parallelism: chain sharding and mutation-axis sharding
over torch.distributed ranks (counterpart of bnpc_tpu/parallel/)."""

from bnpc_tpu_torch.parallel.axis import MutAxis

__all__ = ["MutAxis"]
