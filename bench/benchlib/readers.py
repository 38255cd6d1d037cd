"""What the per-layer readers (``bench/metrics/<metric>.py``) share: each
returns None where the trace, the card's peaks or the range it reads is
missing, never a 0 in their place."""
from __future__ import annotations


def _ok(r, *work) -> bool:
    return r.summary is not None and r.peaks is not None \
        and r.summary.window_s > 0 and all(k in r.work for k in work)


def idle_pct(r) -> float | None:
    """Share of the traced window with no device operation running."""
    if r.summary is None or r.summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.summary.busy_s / r.summary.window_s)


def model_flops_pct(r, key: str) -> float | None:
    """The window's model operations ``work[key]`` over the window at the
    card's bf16 peak."""
    if not _ok(r, key):
        return None
    return 100.0 * r.work[key] / (r.summary.window_s
                                  * r.peaks["bf16_ops_per_s"])


def least_time_pct(r) -> float | None:
    """Each step's least time (its operations at the bf16 peak or its
    bytes at the HBM peak, whichever is longer), summed, over the
    window."""
    if not _ok(r, "step_flops", "step_bytes"):
        return None
    P, BW = r.peaks["bf16_ops_per_s"], r.peaks["hbm_bytes_per_s"]
    least = sum(max(f / P, b / BW)
                for f, b in zip(r.work["step_flops"], r.work["step_bytes"]))
    return 100.0 * least / r.summary.window_s


def range_s(r, name: str) -> float | None:
    if r.summary is None:
        return None
    t = r.summary.range_device_s.get(name, 0.0)
    return t if t > 0 else None


def range_ops_pct(r, name: str, key: str) -> float | None:
    """The operations ``work[key]`` over the device time of the range
    ``name`` at the bf16 peak."""
    t = range_s(r, name)
    if t is None or not _ok(r, key):
        return None
    return 100.0 * r.work[key] / (t * r.peaks["bf16_ops_per_s"])


def range_bytes_pct(r, name: str, key: str) -> float | None:
    """The bytes ``work[key]`` over the device time of the range ``name``
    at the HBM peak."""
    t = range_s(r, name)
    if t is None or not _ok(r, key):
        return None
    return 100.0 * r.work[key] / (t * r.peaks["hbm_bytes_per_s"])


def range_ms_per(r, name: str, key: str) -> float | None:
    """Device milliseconds of the range ``name`` per ``work[key]``."""
    t = range_s(r, name)
    if t is None or not r.work.get(key):
        return None
    return 1e3 * t / r.work[key]
