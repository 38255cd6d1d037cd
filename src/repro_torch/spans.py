"""Named spans in the port's serving step, attention and MoE layer, for
``torch.profiler``.

``span(name)`` opens the profiler range ``repro_torch/<name>`` while a
profiler records, and is one shared ``nullcontext`` otherwise: with no
profiler nothing is formatted, built or allocated.  No span launches a
device operation, reads a tensor back or synchronises.  A span's parent is
the span that encloses it on the same thread; the serving step's span
stands for the request.  The program keeps no counter, buffer or clock of
its own: a trace gives each span's entries, the device operations
launched inside it and the card's idle time within it, on the trace's
clock.

The range is an operator-scope ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``), not a user-scope
``torch.profiler.record_function``: the profiler copies a user-scope range
onto the device's stream as an annotation over every kernel launched
inside it, which a reduction of the device trace would count as a device
operation.  A kernel launched outside any aten op (a hand-written kernel
called through ``ctypes``) is tied in the trace to the innermost span open
at its launch, so such a span opens where the kernel is launched
(``kernels.decode_attention.ops.decode_attention``)."""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch/"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The range ``repro_torch/<name>`` while a profiler records, else the
    shared null context."""
    if _recording():
        return _Range(PREFIX + name)
    return _OFF
