"""Carry an index design across from plain arrays.

The JAX package's state is numpy through and through (keysets, layers,
designs), so it crosses into the port as arrays: a caller reads them off a
design built by either package and hands them to
:func:`design_from_arrays`.  The resident prefix itself crosses as the
index file, which both packages read and write byte for byte.
"""
from __future__ import annotations

import numpy as np

from .keyset import KeyPositions
from .latency import IndexDesign
from .nodes import BandLayer, StepLayer


def _step(d: dict) -> StepLayer:
    return StepLayer(piece_keys=np.asarray(d["piece_keys"], dtype=np.uint64),
                     piece_pos=np.asarray(d["piece_pos"], dtype=np.int64),
                     node_piece_off=np.asarray(d["node_piece_off"],
                                               dtype=np.int64))


def _band(d: dict) -> BandLayer:
    return BandLayer(node_keys=np.asarray(d["node_keys"], dtype=np.uint64),
                     x1=np.asarray(d["x1"], dtype=np.uint64),
                     y1=np.asarray(d["y1"], dtype=np.int64),
                     m=np.asarray(d["m"], dtype=np.float64),
                     delta=np.asarray(d["delta"], dtype=np.float64),
                     clamp_lo=int(d["clamp_lo"]), clamp_hi=int(d["clamp_hi"]))


def design_from_arrays(layers, data: dict) -> IndexDesign:
    """Bottom-up layer dicts + data arrays → the port's :class:`IndexDesign`.

    * step layer: ``{"kind": "step", "piece_keys", "piece_pos",
      "node_piece_off"}``;
    * band layer: ``{"kind": "band", "node_keys", "x1", "y1", "m",
      "delta", "clamp_lo", "clamp_hi"}``;
    * ``data``: ``{"keys", "lo", "hi", "weights"}``.
    """
    built = []
    for d in layers:
        if d["kind"] == "step":
            built.append(_step(d))
        elif d["kind"] == "band":
            built.append(_band(d))
        else:
            raise ValueError(f"unknown layer kind {d['kind']!r}")
    D = KeyPositions(keys=np.asarray(data["keys"], dtype=np.uint64),
                     lo=np.asarray(data["lo"], dtype=np.int64),
                     hi=np.asarray(data["hi"], dtype=np.int64),
                     weights=np.asarray(data["weights"], dtype=np.float64))
    return IndexDesign(layers=tuple(built), data=D)
