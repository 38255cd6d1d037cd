"""Serving specifications of the PyTorch port."""
from .spec import SERVE_BACKENDS, RetryPolicy, ServeSpec

__all__ = ["RetryPolicy", "SERVE_BACKENDS", "ServeSpec"]
