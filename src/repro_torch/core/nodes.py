"""Index layers made of step / band nodes (paper §4.1, Fig. 6).

A *node* maps a key to a position range that must contain the true range
(validity, Eq. 1): ``ŷ(x) = [ŷ⁻(x), ŷ⁺(x)) ⊇ y(x)``.

  * **step** node: p-piece constant function, pieces ``(a_i → [b_i, b_{i+1}))``;
    serialized size ``16·p`` bytes (8 B key + 8 B position per piece).
  * **band** node: thick line through two key-position points with width δ:
    ``ŷ(x) = [m·x + c − δ, m·x + c + δ)``; serialized size 40 bytes.

An *index layer* is a piecewise function of nodes; node ``j`` covers keys
``[z_j, z_{j+1})``.  Layers are stored struct-of-arrays so that lookup is a
vectorized array program.  Band parameters are fitted and evaluated with
the same float64 expression in node-local coordinates (``x − x₁``), so the
validity guarantee established at build time holds bit for bit at lookup.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .descent import descend_band_layer, descend_step_layer
from .keyset import KeyPositions, POS_DTYPE

STEP_PIECE_BYTES = 16   # 8 B partition key + 8 B partition position
BAND_NODE_BYTES = 40    # x1, y1, x2, y2, delta  (5 × 8 B)
LAYER_KINDS = ("step", "band")


@dataclasses.dataclass(frozen=True)
class StepLayer:
    """All step nodes of one layer, pieces flattened in key order.

    Piece ``i`` predicts ``[piece_pos[i], piece_pos[i+1])`` for keys in
    ``[piece_keys[i], piece_keys[i+1])``.  Node ``j`` owns pieces
    ``[node_piece_off[j], node_piece_off[j+1])``.
    """

    piece_keys: np.ndarray      # (P,) uint64
    piece_pos: np.ndarray       # (P+1,) int64
    node_piece_off: np.ndarray  # (N+1,) int64 CSR offsets into pieces

    kind = "step"

    @property
    def n_nodes(self) -> int:
        return len(self.node_piece_off) - 1

    @property
    def n_pieces(self) -> int:
        return len(self.piece_keys)

    def node_sizes(self) -> np.ndarray:
        return STEP_PIECE_BYTES * np.diff(self.node_piece_off)

    @property
    def size_bytes(self) -> int:
        """s(Θ_l): serialized layer size (16p bytes per step node)."""
        return int(STEP_PIECE_BYTES * self.n_pieces)

    def node_keys(self) -> np.ndarray:
        """z_j — the first partition key of each node."""
        return self.piece_keys[self.node_piece_off[:-1]]

    def predict(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """ŷ(x) for a batch of keys → (lo, hi) arrays."""
        return descend_step_layer(self.piece_keys, self.piece_pos[:-1],
                                  self.piece_pos[1:], queries)

    def widths_at(self, queries: np.ndarray) -> np.ndarray:
        """Δ(x; Θ_l) = |ŷ(x)| per query (paper §4.3)."""
        lo, hi = self.predict(queries)
        return (hi - lo).astype(np.float64)

    def piece_widths(self) -> np.ndarray:
        """|ŷ| of each piece: ``piece_pos[i+1] − piece_pos[i]``, float64."""
        return np.diff(self.piece_pos).astype(np.float64)

    def validate_against(self, D: KeyPositions) -> None:
        """Assert Eq. (1) over every key of ``D``: each predicted range
        contains the key's true range."""
        lo, hi = self.predict(D.keys)
        assert np.all(lo <= D.lo) and np.all(hi >= D.hi), \
            "step layer violates Eq. (1)"


@dataclasses.dataclass(frozen=True)
class BandLayer:
    """All band nodes of one layer.

    Node ``j`` covers keys ``[node_keys[j], node_keys[j+1])`` and predicts
    ``mid(x) ± delta`` with ``mid(x) = y1 + m·(x − x1)`` evaluated in
    float64 node-local coordinates.
    """

    node_keys: np.ndarray  # (N,) uint64 == x1 of each node (the key tag)
    x1: np.ndarray         # (N,) uint64
    y1: np.ndarray         # (N,) int64
    m: np.ndarray          # (N,) float64 slope (bytes per key unit)
    delta: np.ndarray      # (N,) float64 half-width
    clamp_lo: int = 0      # predictions clamped into [clamp_lo, clamp_hi]
    clamp_hi: int = np.iinfo(np.int64).max

    kind = "band"

    @property
    def n_nodes(self) -> int:
        return len(self.node_keys)

    def node_sizes(self) -> np.ndarray:
        return np.full(self.n_nodes, BAND_NODE_BYTES, dtype=POS_DTYPE)

    @property
    def size_bytes(self) -> int:
        return int(BAND_NODE_BYTES * self.n_nodes)

    def predict(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = descend_band_layer(self.node_keys, self.x1, self.y1, self.m,
                                    self.delta, queries)
        lo = np.clip(lo, self.clamp_lo, self.clamp_hi).astype(POS_DTYPE)
        hi = np.clip(hi, self.clamp_lo, self.clamp_hi).astype(POS_DTYPE)
        return lo, np.maximum(hi, lo + 1)

    def widths_at(self, queries: np.ndarray) -> np.ndarray:
        lo, hi = self.predict(queries)
        return (hi - lo).astype(np.float64)

    def validate_against(self, D: KeyPositions) -> None:
        """Assert Eq. (1) over every key of ``D`` (the clamped band)."""
        lo, hi = self.predict(D.keys)
        assert np.all(lo <= D.lo) and np.all(hi >= D.hi), \
            "band layer violates Eq. (1)"


Layer = StepLayer | BandLayer


def outline(layer: Layer, D: KeyPositions, base: int = 0) -> KeyPositions:
    """Turn a built layer into the key-position collection seen by the next
    layer up (Alg. 2 line 5): keys = node boundary keys z_j, positions =
    byte ranges of serialized node records, weights = covered query mass.
    """
    sizes = layer.node_sizes()
    offs = np.empty(len(sizes) + 1, dtype=POS_DTYPE)
    offs[0] = base
    np.cumsum(sizes, out=offs[1:])
    offs[1:] += base
    if isinstance(layer, StepLayer):
        zkeys = layer.node_keys()
    else:
        zkeys = layer.node_keys
    # weight of node j = total weight of D-pairs it covers, from boundary
    # positions over a weight prefix sum
    cw = np.concatenate([[0.0], np.cumsum(D.weights)])
    bounds = np.searchsorted(D.keys, zkeys, side="left")
    ends = np.append(bounds[1:], D.n)
    w = cw[ends] - cw[bounds]
    w = np.maximum(w, 1e-9)   # guard: empty nodes keep a token weight
    return KeyPositions(keys=zkeys.astype(np.uint64), lo=offs[:-1], hi=offs[1:],
                        weights=w)


def mean_width(layer: Layer, D: KeyPositions) -> float:
    """E_{x∼X}[Δ(x; Θ_l)] with X uniform over original keys (weights)."""
    wq = layer.widths_at(D.keys)
    return float(np.average(wq, weights=D.weights))
