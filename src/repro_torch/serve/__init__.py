"""Serving side of the PyTorch port: the storage seam and the batched
engine."""
from .backend import (CorruptPageError, DeadlineExceededError,
                      FaultInjectingBackend, FileBackend, ReadError,
                      StorageBackend, StorageError, pread_full)
from .index_service import (IndexService, ServeStats, TieredBlockCache,
                            demo_serving_design)

__all__ = ["CorruptPageError", "DeadlineExceededError",
           "FaultInjectingBackend", "FileBackend", "IndexService",
           "ReadError", "ServeStats", "StorageBackend", "StorageError",
           "TieredBlockCache", "demo_serving_design", "pread_full"]
