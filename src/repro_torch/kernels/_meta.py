"""The kernels' side of a trace on the ``meta`` device.

A tensor on ``meta`` has a shape and a type and no values, so a trace of a
step there (``repro_torch.launch.trace_analysis``) runs every PyTorch op
for its shapes alone.  A hand-written kernel is no PyTorch op: its
dispatch takes a ``meta`` branch instead, which allocates on ``meta`` the
buffers its CUDA wrapper allocates on the card and books the kernel's own
work here with :func:`book`.  :func:`recording` installs a list that the
bookings go to; with none installed a booking is dropped.  A branch never
runs the kernel's plain version.
"""
from __future__ import annotations

import contextlib
import dataclasses

#: streaming multiprocessors of the card a meta trace stands for (the
#: H100 SXM), which sizes the decode kernel's split of a row's keys
SMS = 132

_ACTIVE: list = []


@dataclasses.dataclass(frozen=True)
class Booking:
    """One kernel launch a meta branch stood in for: its name, the
    operations it does (multiply-adds count two) and the bytes it must
    move (each input read once, each output written once)."""
    kernel: str
    flops: float
    bytes: float


def book(kernel: str, flops: float, nbytes: float) -> None:
    """Book one launch of ``kernel`` to the innermost :func:`recording`."""
    if _ACTIVE:
        _ACTIVE[-1].append(Booking(kernel, float(flops), float(nbytes)))


@contextlib.contextmanager
def recording(into: list):
    """Send every :func:`book` inside the block to ``into``."""
    _ACTIVE.append(into)
    try:
        yield into
    finally:
        _ACTIVE.remove(into)

