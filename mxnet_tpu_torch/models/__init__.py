"""Model zoo of the port (the transformer LM of the serving slice)."""
from . import transformer  # noqa: F401
