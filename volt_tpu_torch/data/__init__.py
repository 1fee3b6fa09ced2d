"""Host-side data for the port (numpy only)."""

from .synthetic import sabr_paths

__all__ = ["sabr_paths"]
