from .check import CheckEngine, clamp_depth
from .closure import ClosureCheckEngine

__all__ = ["CheckEngine", "ClosureCheckEngine", "clamp_depth"]
