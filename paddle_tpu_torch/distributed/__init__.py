"""Training engines of the port (single-device ``Engine`` in this slice)."""

from .auto_parallel import Engine  # noqa: F401
