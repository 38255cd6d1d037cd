"""AirIndex on PyTorch and CUDA: the port of the JAX package ``repro``.

Host code (keysets, builders, the index file, the disk walk) is numpy, as
in the JAX package; the resident-prefix descent runs in a hand-written
Hopper kernel.  The port never imports ``jax`` or ``repro``.
"""

__all__: list = []
