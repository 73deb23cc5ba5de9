"""Model zoo of the port: the transformer LM and the pre-activation ResNet,
each served and trained."""
from . import resnet, transformer  # noqa: F401
