"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, which stays the reference. It follows
the JAX package's module layout and names; inside it is PyTorch: ops are
plain functions on tensors, devices are explicit, and the TPU's Pallas
kernels on its path are hand-written CUDA kernels for Hopper
(``csrc/``), each beside a plain PyTorch version of the same function.

Entry points run on ``gpu(0)`` (CUDA) unless the caller passes
``ctx=cpu()``; a missing GPU raises, it never falls back to the CPU.

The port computes in float32 throughout, as the JAX serving path does. So
that a float32 product on the card is a float32 product, TF32 is switched
off for both matmuls and cuDNN here, when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .base import MXNetError  # noqa: E402
from .context import Context, cpu, gpu, current_context  # noqa: E402
from . import ops  # noqa: E402,F401
from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402,F401
from .name import NameManager  # noqa: E402,F401
from .executor import Executor, bind, simple_bind  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import models, serving  # noqa: E402,F401
from .convert import params_from_numpy  # noqa: E402,F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "sym", "symbol",
           "ops", "optimizer", "models", "serving", "params_from_numpy"]
