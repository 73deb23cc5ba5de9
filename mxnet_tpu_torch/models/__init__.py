"""Model zoo of the port: the transformer LM and the pre-activation ResNet,
each served and trained, and the MNIST nets ``mlp`` and ``lenet``."""
from . import lenet, mlp, resnet, transformer  # noqa: F401
