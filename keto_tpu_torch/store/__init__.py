from .columnar import ColumnarTupleStore
from .memory import InMemoryTupleStore

__all__ = ["InMemoryTupleStore", "ColumnarTupleStore"]
