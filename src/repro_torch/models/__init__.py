"""The LM scaffold's models: per-layer ``nn.Module``s over the plain
attention, scan and routing cores of ``layers``; ``zoo.build(cfg)`` is the
entry point."""

from .zoo import Model, build

__all__ = ["Model", "build"]
