"""Deprecation shims: warn outside callers, hard-fail inside the package.

The ``repro_torch.api`` facade is the port's one tune → save → serve
surface.  The JAX package's older entry points (``core.load_index``,
``core.lookup.lookup_file``, ``IndexService``'s pre-spec keywords,
``IndexService.fd``, ``Index.serve(use_device=...)``) stay as thin shims
that delegate to the facade bit-identically, so a caller's code moves to
the port unchanged and migrates at its own pace.  Code inside
``repro_torch`` must use the facade (or the engine layer directly): an
internal call through a shim is a bug and raises at once instead of
warning.
"""
from __future__ import annotations

import sys
import warnings

_WARNED: set = set()    # messages already emitted once (see ``once=True``)


def warn_deprecated(message: str, *, stacklevel: int = 3,
                    once: bool = False) -> None:
    """Emit a ``DeprecationWarning`` attributed to the shim's caller.

    ``stacklevel=3`` assumes the call chain ``caller -> shim ->
    warn_deprecated``; pass a larger value for deeper shims.

    ``once=True`` emits each distinct message at most once per process
    (``IndexService``'s legacy keywords would otherwise warn on every
    open in a serving loop).  The internal-use error is not deduplicated:
    a call from inside ``repro_torch`` always raises, warned before or
    not.
    """
    caller = sys._getframe(stacklevel - 1).f_globals.get("__name__", "")
    if caller == "repro_torch" or caller.startswith("repro_torch."):
        raise AssertionError(
            f"deprecated API used from within repro_torch ({caller}): "
            f"{message}")
    if once:
        if message in _WARNED:
            return
        _WARNED.add(message)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)
