"""The JAX package's seeded parameter draws, without jax.

``jax.random.PRNGKey(seed)``, ``jax.random.split`` and
``jax.random.normal(key, shape, float32)`` as jax 0.9 computes them on
the CPU, in PyTorch on any device:

* **threefry2x32** in the partitionable mode (``jax_threefry_partitionable``
  on, jax's default): element ``i`` of a draw hashes the counter pair
  ``(i >> 32, i & 0xffffffff)`` under the key, and its 32 random bits are
  the xor of the two output words; ``split(key, n)`` hashes ``(0, i)`` and
  keeps both words as key ``i``.  Integer arithmetic is exact, so the bits
  equal jax's on every device.  Words live in int64 tensors, masked to 32
  bits after each add and shift.
* **uniform → normal**: the top 23 bits become a float in [1, 2), shifted
  to [nextafter(−1, 0), 1), then ``sqrt(2)·erf_inv(u)``.  ``erf_inv`` is
  XLA's expansion (Giles' polynomial in ``w = −log1p(−u²)``), and
  ``log1p``, ``log`` and ``sqrt`` are XLA's CPU expansions (the Cephes
  rational and polynomial; a Newton step on ``x·rsqrt(x)``), with the
  multiply-adds XLA's compiler fuses done as fused multiply-adds
  (:func:`fma`).  Every other operation is a correctly rounded float32
  operation in both.

A draw runs in chunks (:func:`chunk`: :data:`CHUNK` elements on the CPU,
:data:`CHUNK_CUDA` on a card), so its int64 and float64 temporaries stay
near 123 bytes an element of a chunk whatever the leaf's size.  A chunk
is about a thousand elementwise ops; on a card 2^20 elements leave them
launch-bound (11.4 ns an element on an H100) and 2^22 near memory-bound
(6.4 ns; ``probes/init_draw.py``).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: elements a chunk of a draw on the CPU, and on a card (its temporaries
#: take 123 bytes an element)
CHUNK = 1 << 20
CHUNK_CUDA = 1 << 22

_F32 = torch.float32


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``: the two 32-bit words of a 64-bit
    seed, high word first."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, not {seed}")
    return (seed >> 32) & MASK, seed & MASK


def chunk(device) -> int:
    """Elements a chunk of a draw on ``device``."""
    return CHUNK_CUDA if torch.device(device).type == "cuda" else CHUNK


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1``
    (int64 tensors of 32-bit values) under ``key`` → two int64 tensors."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r) & MASK).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def split(key: tuple, n: int) -> list:
    """``jax.random.split(key, n)`` → ``n`` keys."""
    i = torch.arange(n, dtype=torch.int64)
    w0, w1 = threefry2x32(key, torch.zeros_like(i), i)
    return list(zip(w0.tolist(), w1.tolist()))


def random_bits(key: tuple, start: int, n: int, device) -> torch.Tensor:
    """32 random bits (an int64 tensor) for the flat elements
    ``[start, start + n)`` of a draw under ``key``."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(key, i >> 32, i & MASK)
    return w0.bitwise_xor_(w1)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=like.device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Float32 ``a·b + c`` rounded once, for results in float32's normal
    range.  The product is exact in float64 and the float64 sum is
    rounded once; rounding that sum to float32 can differ from the fused
    result only where the sum is inexact and lands on a float32 midpoint
    (low 29 bits of its mantissa ``1 << 28``).  There the sum is moved one
    float64 step toward the exact value (rounding to odd), which the
    float32 rounding then resolves as the fused operation does.  The
    correction is computed everywhere and selected, so the host never
    waits on the device."""
    p, c = torch.broadcast_tensors(a.double() * b.double(), c.double())
    s = p + c
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    v = s - p
    err = (p - (s - v)) + (c - v)                  # the sum's exact error
    toward = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf),
                                               err))
    return torch.where(mid & (err != 0), toward, s).float()


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU for positive normal ``x``: Cephes'
    ``logf`` polynomial after splitting off the exponent."""
    bits = x.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 126).to(_F32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)      # [0.5, 1)
    small = m < _f32(0.707106781186547524, x)
    one = _f32(1.0, x)
    zero = _f32(0.0, x)
    e = e - torch.where(small, one, zero)
    m = (m - one) + torch.where(small, m, zero)
    m2 = m * m
    m3 = m2 * m
    c = [_f32(v, x) for v in _LOG_P]
    y = fma(fma(m, c[0], c[1]), m, c[2])
    y1 = fma(fma(m, c[3], c[4]), m, c[5])
    y2 = fma(fma(m, c[6], c[7]), m, c[8])
    y = fma(fma(y, m3, y1), m3, y2)
    y = fma(y, m3, e * _f32(-2.12194440e-4, x))
    m = fma(m2, _f32(-0.5, x), m) + y
    return fma(e, _f32(0.693359375, x), m)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, _f32(c, x))
    return p


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    return x + (_f32(-0.5, x) * x2 + (x * x2) * r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU for ``x`` > −1: Cephes'
    rational form below |x| = sqrt(2) − 1, else :func:`xla_log` of
    ``1 + x`` (both computed everywhere, one selected)."""
    small = x.abs() < _f32(0.41421356237309504880, x)
    return torch.where(small, _log1p_small(x), xla_log(x + 1.0))


def xla_sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``sqrt`` on the CPU: ``s = x·r`` from the reciprocal
    square root ``r``, then one Newton step ``s + r/2·(x − s²)``."""
    r = torch.rsqrt(x.double()).float()
    s = x * r
    return fma(_f32(0.5, x) * r, fma(-s, s, x), s)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _poly(w: torch.Tensor, coeffs) -> torch.Tensor:
    p = _f32(coeffs[0], w)
    for c in coeffs[1:]:
        p = fma(p, w, _f32(c, w))
    return p


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' single-precision polynomial)
    for |x| < 1, both branches computed everywhere and one selected."""
    w = -xla_log1p(x * -x)
    p = torch.where(w < _f32(5.0, x), _poly(w - 2.5, _ERFINV_LT5),
                    _poly(xla_sqrt(w) - 3.0, _ERFINV_GT5))
    return torch.where(x.abs() == 1, x * torch.inf, p * x)


_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: tuple, start: int, n: int, device) -> torch.Tensor:
    """Elements ``[start, start + n)`` of the flat
    ``jax.random.normal(key, shape, float32)`` → float32 (n,)."""
    bits = random_bits(key, start, n, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0
    lo = _f32(_LO, f)
    u = torch.maximum(lo, f * 2.0 + lo)
    return _f32(_SQRT2, u) * erf_inv(u)



def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 (``num`` > 1) as XLA
    compiles it: ``t = i·c`` with ``c`` the float32 reciprocal of
    ``num − 1``, then ``start·(1 − t) + i·(stop·c)`` with the last
    product fused into the add; the last element is ``stop``."""
    i = torch.arange(num - 1, dtype=_F32, device=device)
    c = torch.tensor(1.0, dtype=_F32, device=device) / float(num - 1)
    head = torch.tensor(start, dtype=_F32, device=device) * (1.0 - i * c)
    stop_c = torch.tensor(stop, dtype=_F32, device=device) * c
    out = fma(i, stop_c.expand_as(i), head)
    return torch.cat([out, torch.full((1,), stop, dtype=_F32,
                                      device=device)])
