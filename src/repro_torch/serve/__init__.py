"""Serving side of the PyTorch port: the storage seam, the batched index
engine, and the LLM serving steps (prefill and decode)."""
from .backend import (CorruptPageError, DeadlineExceededError,
                      FaultInjectingBackend, FileBackend, ReadError,
                      StorageBackend, StorageError, pread_full)
from .index_service import (IndexService, ServeStats, TieredBlockCache,
                            cacheable_working_set, demo_serving_design,
                            load_serve_stats, load_stats_history,
                            observed_profile_from_stats, save_stats_snapshot,
                            stats_path)
from .serve_step import make_decode_step, make_prefill_step

__all__ = ["CorruptPageError", "DeadlineExceededError",
           "FaultInjectingBackend", "FileBackend", "IndexService",
           "ReadError", "ServeStats", "StorageBackend", "StorageError",
           "TieredBlockCache", "cacheable_working_set", "demo_serving_design",
           "load_serve_stats", "load_stats_history", "make_decode_step",
           "make_prefill_step", "observed_profile_from_stats", "pread_full",
           "save_stats_snapshot", "stats_path"]
