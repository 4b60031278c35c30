from .config import Config
from .registry import Registry

__all__ = ["Config", "Registry"]
