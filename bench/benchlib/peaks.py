"""Published peaks of the cards a run may land on.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3, 80 GB.  A card set below
700 W reaches less; a run reports its ``power.limit`` beside the shares."""
from __future__ import annotations

import subprocess

PEAKS = {
    "H100": {"bf16_ops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or
    None for a card the table lacks (its shares are then not read)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi`` (watts), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
