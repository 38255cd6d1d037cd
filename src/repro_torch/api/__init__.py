"""Tuning and serving specifications of the PyTorch port."""
from .spec import SERVE_BACKENDS, RetryPolicy, ServeSpec, TuneSpec

__all__ = ["RetryPolicy", "SERVE_BACKENDS", "ServeSpec", "TuneSpec"]
