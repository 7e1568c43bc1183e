"""Rule plugins — importing this package registers every rule family."""
from __future__ import annotations

from . import determinism, jitpurity, obs, protocol  # noqa: F401

__all__ = ["determinism", "jitpurity", "obs", "protocol"]
