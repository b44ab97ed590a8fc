"""bnpc_tpu_torch — the PyTorch / CUDA port of bnpc_tpu.

Dirichlet-process mixture clustering of binary single-cell mutation matrices
(BnpC, Borgsmüller et al., Bioinformatics 2020), sampled by MCMC. The module
layout mirrors ``bnpc_tpu`` one for one; the two serial hot loops of the step
(the Gibbs sweep segment and the split-merge restricted scan) are CUDA
kernels written for Hopper (``csrc/``), everything else is plain torch.

The package never imports jax or bnpc_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# Log-likelihood sums and integer sufficient-statistic counts need true
# float32 matmuls: TF32 keeps ~3 decimal digits. Counterpart of
# bnpc_tpu/__init__.py's jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from bnpc_tpu_torch.config import MCMCConfig, ModelConfig  # noqa: E402
from bnpc_tpu_torch.data import PackedData, pack_data  # noqa: E402
from bnpc_tpu_torch.state import CRPState  # noqa: E402

__all__ = [
    "ModelConfig",
    "MCMCConfig",
    "PackedData",
    "pack_data",
    "CRPState",
    "__version__",
]
