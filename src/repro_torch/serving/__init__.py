"""Serving over the model zoo: ``generate`` and decode-cache growth."""

from .engine import Generation, generate, grow_cache

__all__ = ["Generation", "generate", "grow_cache"]
