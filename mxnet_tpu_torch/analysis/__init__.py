"""Graph passes of the port (the bind-time rewrite)."""
from .rewrite import rewrite, rewrite_for_bind  # noqa: F401
