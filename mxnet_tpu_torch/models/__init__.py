"""Model zoo of the port (the transformer LM, served and trained)."""
from . import transformer  # noqa: F401
