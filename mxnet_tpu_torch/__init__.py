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

The native runtime (``engine``, ``recordio``, ``io_native``,
``image_native``, ``image``, the C ABIs ``c_api``/``predict_api``) builds
its host libraries with ``g++`` into ``build/torch_native/`` on first use.
"""
__version__ = "0.1.0"

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .base import MXNetError  # noqa: E402
from .context import Context, cpu, gpu, current_context, num_gpus  # noqa: E402,F401
from .attribute import AttrScope  # noqa: E402
from . import ops  # noqa: E402,F401
from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402,F401
from .name import NameManager  # noqa: E402,F401
from .executor import Executor, bind, simple_bind  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import telemetry, faultinject  # noqa: E402,F401
from . import models, serving  # noqa: E402,F401
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402,F401
from . import model, predictor, random, rtc  # noqa: E402,F401
from . import io, initializer, lr_scheduler, metric, callback, monitor  # noqa: E402,F401
from . import initializer as init  # noqa: E402,F401
from . import checkpoint, kvstore_helper, device_info  # noqa: E402,F401
from . import kvstore, dist, sparse  # noqa: E402,F401
from . import kvstore as kv  # noqa: E402,F401
from . import module  # noqa: E402,F401
from . import module as mod  # noqa: E402,F401
from . import parallel  # noqa: E402,F401
from . import analysis  # noqa: E402,F401
from . import rnn  # noqa: E402,F401
from . import operator, autograd, test_utils  # noqa: E402,F401
from .convert import (params_from_checkpoint, params_from_numpy,  # noqa: E402,F401
                      updater_states_from_numpy)
from . import engine, recordio, log, libinfo  # noqa: E402,F401
from . import image  # noqa: E402,F401
from . import image as img  # noqa: E402,F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "AttrScope", "sym", "symbol",
           "nd", "ndarray", "ops", "optimizer", "models", "serving", "model", "predictor",
           "random", "rtc", "telemetry", "faultinject", "io", "initializer", "init",
           "lr_scheduler", "metric", "callback", "monitor", "checkpoint", "kvstore_helper",
           "kvstore", "kv", "dist", "sparse",
           "device_info", "module", "mod", "parallel", "analysis", "rnn", "operator", "autograd", "test_utils",
           "params_from_numpy", "params_from_checkpoint",
           "updater_states_from_numpy", "engine", "recordio", "image", "img", "log", "libinfo"]
