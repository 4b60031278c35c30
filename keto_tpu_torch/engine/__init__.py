from .check import CheckEngine, clamp_depth
from .closure import ClosureCheckEngine
from .device import DeviceCheckEngine

__all__ = ["CheckEngine", "ClosureCheckEngine", "DeviceCheckEngine", "clamp_depth"]
