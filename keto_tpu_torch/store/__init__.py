from .columnar import ColumnarTupleStore
from .durable import DurableTupleStore, RecoveryReport, recover_store
from .memory import InMemoryTupleStore
from .wal import WalError, WriteAheadLog

__all__ = [
    "ColumnarTupleStore",
    "DurableTupleStore",
    "InMemoryTupleStore",
    "RecoveryReport",
    "WalError",
    "WriteAheadLog",
    "recover_store",
]
