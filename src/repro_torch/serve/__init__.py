"""Serving side of the PyTorch port: the storage seam, the batched index
engine, and the LLM serving steps (prefill and decode)."""
from .backend import (CorruptPageError, DeadlineExceededError,
                      FaultInjectingBackend, FileBackend, ReadError,
                      StorageBackend, StorageError, pread_full)
from .index_service import (IndexService, ServeStats, TieredBlockCache,
                            demo_serving_design)
from .serve_step import make_decode_step, make_prefill_step

__all__ = ["CorruptPageError", "DeadlineExceededError",
           "FaultInjectingBackend", "FileBackend", "IndexService",
           "ReadError", "ServeStats", "StorageBackend", "StorageError",
           "TieredBlockCache", "demo_serving_design", "make_decode_step",
           "make_prefill_step", "pread_full"]
