from .definitions import MemoryNamespaceManager, Namespace, NamespaceManager

__all__ = ["Namespace", "NamespaceManager", "MemoryNamespaceManager"]
