"""The reference's products, in float32 or in the control's float8.

A product of an activation and a weight drawn in bfloat16 is float32: on
the card a float32 matmul at full rate is single-pass TF32 (10 mantissa
bits), so the activation is split into a high part with 10 mantissa bits,
which TF32 holds exactly, and the rest, and the two products (the weight
has no low part) are summed in float32; what is left out lies below 2^-20
of the result.  On the CPU it is a plain float32 matmul.  Attention's
products (``transformer.attention``) are float32 with TF32 off.

``fp8`` is the control: the configuration states bfloat16, and the
precision below it is float8 (e4m3).  Both operands of a weight product
are rounded to float8 with one scale a row of the activation and a column
of the weight (the usual fp8 serving recipe); the float8 codes multiply
exactly and sum in float32, and the scales are applied after."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3 value


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matmuls on (or off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _high(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 lowest mantissa bits cleared (exact in TF32)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


#: activation rows one split product takes at a time (bounds its
#: temporaries)
ROWS = 1 << 16


def exact(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in float32, where w's values are exact in TF32 (bfloat16 or
    float8 values)."""
    a = a.float()
    w = w.float()
    if a.device.type != "cuda":
        return a @ w
    rows = a.reshape(-1, a.shape[-1])
    out = torch.empty((rows.shape[0], w.shape[-1]), device=a.device)
    with tf32(True):
        for r0 in range(0, rows.shape[0], ROWS):
            r = rows[r0:r0 + ROWS]
            r_hi = _high(r)
            torch.add(r_hi @ w, (r - r_hi) @ w, out=out[r0:r0 + ROWS])
    return out.view(*a.shape[:-1], w.shape[-1])


def fp8_codes(x: torch.Tensor, dim: int) -> tuple:
    """x rounded to float8 e4m3 with one scale along ``dim`` (the
    reduction dimension) → (the codes as float32, the scales)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float(), scale


class Precision:
    """The products of one reference run: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def weight(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """An activation (..., in) times a weight (in, out)."""
        if self.name == "fp8":
            ca, sa = fp8_codes(a.float(), -1)
            cw, sw = fp8_codes(w.float(), -2)
            return exact(ca, cw) * sa * sw
        return exact(a, w)
