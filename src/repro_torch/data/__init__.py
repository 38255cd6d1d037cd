"""The training input pipeline of the port: the paper's synthetic key
distributions and the AirIndex-backed token store (the JAX package's
``repro.data``)."""
from .datasets import DATASETS, sosd_like
from .store import ShardedTokenStore, write_token_store

__all__ = ["DATASETS", "ShardedTokenStore", "sosd_like", "write_token_store"]
