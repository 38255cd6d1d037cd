"""On-disk index format + real partial-read lookup (paper §5.6).

Layout (single index file, layers bottom-up):

    [magic u64][json_len u64][json meta][layer_1 bytes] … [layer_L bytes]

Per-layer bytes are the concatenated node records whose byte offsets are
exactly the outline positions used during tuning, so modeled read sizes
equal real read sizes:

  * step layer — stream of 16 B pieces ``(key u64, pos i64)``;
  * band layer — 40 B records ``(x1 u64, y1 f64, m f64, δ f64, rsv u64)``.

Readers fetch *ranges* (``pread``), never whole layers (except the root,
per Alg. 1), align to record boundaries, and for step layers extend by one
record to obtain the next piece's position (fence-pointer style).

**Paged layout** (``write_index(..., page_bytes=N)``): every layer offset
is aligned up to a multiple of ``page_bytes`` (gaps are file holes), so
each page belongs to exactly one layer and carries a CRC32 in the meta.
``page_bytes=0`` keeps the densely-packed format; readers accept both.

The format is the JAX package's byte for byte: either package reads the
files the other writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from .descent import descend_band_layer, descend_step_layer
from .keyset import KeyPositions
from .latency import IndexDesign
from .nodes import BandLayer, StepLayer

MAGIC = 0x41495249  # "AIRI"
_STEP_DT = np.dtype([("key", "<u8"), ("pos", "<i8")])
_BAND_DT = np.dtype([("x1", "<u8"), ("y1", "<f8"), ("m", "<f8"),
                     ("delta", "<f8"), ("rsv", "<u8")])


@dataclasses.dataclass
class LayerMeta:
    kind: str
    offset: int      # byte offset of the layer within the file
    size: int        # serialized size (== Θ_l's s(Θ_l))
    end_pos: int     # position after the layer's last prediction target
    # per-page CRC32 table of a paged layout: entry k covers the layer's
    # k-th page, over its bytes zero-padded to page_bytes; None on densely
    # packed layouts and on files written without checksums
    page_crcs: list | None = None


@dataclasses.dataclass
class IndexFileMeta:
    layers: list          # bottom-up LayerMeta
    data_size: int        # extent of the data layer (for clamping)
    data_record: int      # fixed record size of the data layer (0 = varlen)
    page_bytes: int = 0   # fixed page size (0 = densely packed, unpaged)
    tune: dict | None = None   # provenance recorded by the writer

    def to_json(self) -> str:
        d = {
            "layers": [dataclasses.asdict(l) for l in self.layers],
            "data_size": self.data_size, "data_record": self.data_record,
            "page_bytes": self.page_bytes,
        }
        if self.tune is not None:
            d["tune"] = self.tune
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "IndexFileMeta":
        d = json.loads(s)
        return IndexFileMeta(
            layers=[LayerMeta(**l) for l in d["layers"]],
            data_size=d["data_size"], data_record=d["data_record"],
            page_bytes=d.get("page_bytes", 0), tune=d.get("tune"))


RECORD_BYTES = {"step": 16, "band": 40}


def page_span(offset: int, size: int, page_bytes: int) -> tuple[int, int]:
    """File-global page ids [first, last) covering bytes [offset, offset+size)."""
    return offset // page_bytes, -(-(offset + size) // page_bytes)


def record_aligned_range(kind: str, lo, hi, layer_size: int):
    """Byte range of a layer to fetch for predicted positions ``[lo, hi)``.

    Vectorized over queries.  Aligns down/up to record boundaries; step
    layers extend by one record so the *next* piece's position (the range
    end, fence-pointer style) is always present.  Degenerate ``hi <= lo``
    predictions still fetch one record.
    """
    rsz = RECORD_BYTES[kind]
    a = (np.maximum(lo, 0) // rsz) * rsz
    b = -(-np.asarray(hi) // rsz) * rsz + (rsz if kind == "step" else 0)
    b = np.minimum(np.maximum(b, a + rsz), layer_size)
    a = np.minimum(a, b - rsz)
    return a.astype(np.int64), b.astype(np.int64)


def page_crc(chunk: bytes, page_bytes: int) -> int:
    """CRC32 of one page as stored on disk, zero-padded to ``page_bytes``
    (an alignment hole and a file truncated at EOF pad to the same bytes)."""
    if len(chunk) < page_bytes:
        chunk = chunk + b"\0" * (page_bytes - len(chunk))
    return zlib.crc32(chunk) & 0xFFFFFFFF


def layer_page_crcs(blob: bytes, page_bytes: int) -> list:
    """The per-page CRC32 table of one page-aligned layer blob."""
    return [page_crc(blob[k:k + page_bytes], page_bytes)
            for k in range(0, max(len(blob), 1), page_bytes)]


def _layer_bytes(layer) -> bytes:
    if isinstance(layer, StepLayer):
        rec = np.empty(layer.n_pieces, dtype=_STEP_DT)
        rec["key"] = layer.piece_keys
        rec["pos"] = layer.piece_pos[:-1]
        return rec.tobytes()
    rec = np.empty(layer.n_nodes, dtype=_BAND_DT)
    rec["x1"] = layer.x1
    rec["y1"] = layer.y1.astype(np.float64)
    rec["m"] = layer.m
    rec["delta"] = layer.delta
    rec["rsv"] = 0
    return rec.tobytes()


def write_index(path: str, design: IndexDesign, data_record: int = 0,
                page_bytes: int = 0, tune: dict | None = None,
                checksums: bool = True) -> IndexFileMeta:
    """Serialize a design.  ``page_bytes > 0`` aligns every layer to page
    boundaries (the serving engine's cache unit) and, with ``checksums``,
    records a per-page CRC32 table; 0 keeps the densely-packed layout.
    ``tune`` is an optional JSON-serializable provenance dict."""
    metas = []
    blobs = []
    for layer in design.layers:
        b = _layer_bytes(layer)
        assert len(b) == layer.size_bytes, "serialized size must match s(Θ_l)"
        end_pos = int(layer.piece_pos[-1]) if isinstance(layer, StepLayer) \
            else int(layer.clamp_hi)
        crcs = layer_page_crcs(b, page_bytes) \
            if page_bytes > 0 and checksums else None
        metas.append(LayerMeta(kind=layer.kind, offset=0, size=len(b),
                               end_pos=end_pos, page_crcs=crcs))
        blobs.append(b)
    meta = IndexFileMeta(layers=metas, data_size=design.data.size_bytes,
                         data_record=data_record, page_bytes=page_bytes,
                         tune=tune)

    def _align(off: int) -> int:
        return off if page_bytes == 0 else -(-off // page_bytes) * page_bytes

    def _place(base: int) -> None:
        off = base
        for m, b in zip(metas, blobs):
            m.offset = _align(off)
            off = m.offset + len(b)

    hdr = meta.to_json().encode()
    base = 16 + len(hdr)
    _place(base)
    hdr = meta.to_json().encode()  # re-encode with final offsets
    # json length changes offsets only if digit counts change; fix-point it
    while 16 + len(hdr) != base:
        base = 16 + len(hdr)
        _place(base)
        hdr = meta.to_json().encode()
    with open(path, "wb") as f:
        f.write(np.asarray([MAGIC, len(hdr)], dtype="<u8").tobytes())
        f.write(hdr)
        for m, b in zip(metas, blobs):
            f.seek(m.offset)      # alignment gaps become file holes (zeros)
            f.write(b)
    return meta


def parse_meta(pread) -> IndexFileMeta:
    """Read + decode the header through any ``pread(nbytes, offset)``
    callable.  Raises ``ValueError`` on a bad magic or an undecodable
    header, so a torn read is retryable."""
    head = pread(16, 0)
    if len(head) != 16:
        raise ValueError(f"bad index file: short header ({len(head)} B)")
    magic, hlen = np.frombuffer(head, dtype="<u8")
    if magic != MAGIC:
        raise ValueError(f"bad index file: magic {int(magic):#x}")
    return IndexFileMeta.from_json(pread(int(hlen), 16).decode())


def read_meta(fd: int) -> IndexFileMeta:
    """Header from an already-open raw fd — compat seam for callers that
    own their descriptor (tests, tooling); path-based callers should use
    :func:`read_meta_path`, which reads through the StorageBackend."""
    # airlint: allow[pread-seam] -- raw-fd compat seam; the caller owns the
    # descriptor and path-based internal callers use read_meta_path instead
    return parse_meta(lambda n, off: os.pread(fd, n, off))


def open_file_backend(path: str):
    """A :class:`repro_torch.serve.FileBackend` for ``path`` (lazy import:
    serve sits above core in the layer order)."""
    from repro_torch.serve.backend import FileBackend
    return FileBackend(path)


def read_meta_path(path: str) -> IndexFileMeta:
    """Header of the index file at ``path``, read through the
    StorageBackend seam."""
    be = open_file_backend(path)
    try:
        return parse_meta(be.pread)
    finally:
        be.close()


def load_index(path: str, data: KeyPositions) -> IndexDesign:
    """Deprecated shim: use ``repro_torch.api.Index.open(path,
    data=data).design``, which calls :func:`materialize_design`; the
    result is bit-identical."""
    from .deprecation import warn_deprecated
    warn_deprecated(
        "repro_torch.core.load_index(path, data) is deprecated; use "
        "repro_torch.api.Index.open(path, data=data).design")
    from repro_torch.api import Index
    return Index.open(path, data=data).design


def materialize_design(path: str, data: KeyPositions) -> IndexDesign:
    """Full deserialization (round-trips, re-tuning); real lookups use
    ranges.  Step node grouping and band ``clamp_lo`` are not persisted:
    each piece reads back as a node and ``clamp_lo`` as 0."""
    be = open_file_backend(path)
    try:
        meta = parse_meta(be.pread)
        layers = []
        for lm in meta.layers:
            raw = be.pread(lm.size, lm.offset)
            if lm.kind == "step":
                rec = np.frombuffer(raw, dtype=_STEP_DT)
                pos = np.append(rec["pos"].astype(np.int64), lm.end_pos)
                off = np.arange(len(rec) + 1, dtype=np.int64)
                layers.append(StepLayer(piece_keys=rec["key"].copy(),
                                        piece_pos=pos,
                                        node_piece_off=off))
            else:
                rec = np.frombuffer(raw, dtype=_BAND_DT)
                layers.append(BandLayer(
                    node_keys=rec["x1"].copy(), x1=rec["x1"].copy(),
                    y1=rec["y1"].astype(np.int64), m=rec["m"].copy(),
                    delta=rec["delta"].copy(),
                    clamp_lo=0, clamp_hi=lm.end_pos))
        return IndexDesign(layers=tuple(layers), data=data)
    finally:
        be.close()


# ---------------------------------------------------------------------------
# real partial-read lookup (Alg. 1 against the file)
# ---------------------------------------------------------------------------
def predict_from_records(kind: str, raw: bytes, queries: np.ndarray,
                         end_pos: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse fetched records and run one layer of descent for a query batch
    (Alg. 1 l. 3–5).  ``end_pos`` caps the last fetched step record's range
    (its fence pointer is the next record, absent at the layer end)."""
    q = np.asarray(queries, dtype=np.uint64)
    if kind == "step":
        rec = np.frombuffer(raw, dtype=_STEP_DT)
        pos = rec["pos"].astype(np.int64)
        pos_hi = np.append(pos[1:], np.int64(end_pos))
        return descend_step_layer(rec["key"], pos, pos_hi, q)
    rec = np.frombuffer(raw, dtype=_BAND_DT)
    return descend_band_layer(rec["x1"], rec["x1"], rec["y1"], rec["m"],
                              rec["delta"], q)


def record_keys(kind: str, raw: bytes) -> np.ndarray:
    """Sorted partition keys of fetched records (covering-search domain)."""
    return np.frombuffer(raw, dtype=_STEP_DT if kind == "step" else _BAND_DT)[
        "key" if kind == "step" else "x1"]


def gallop_step(kind: str, a: int, b: int) -> int:
    """Extension step for a missed window ``[a, b)``: the window's own
    width, but never less than one record, so a zero-width window cannot
    retry with the same bounds forever."""
    return max(b - a, RECORD_BYTES[kind])


def window_misses(kind: str, raw: bytes, a: int, b: int, layer_size: int,
                  queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-query check that a fetched window ``[a, b)`` contains the true
    covering record.

    A band upper layer's containment guarantee holds at the outline's
    boundary keys only, so for keys between boundaries its window can land
    next to the covering record.  Misses are detectable without extra I/O:

      * left miss  — every fetched key > q and bytes exist before the window;
      * right miss — the last fetched key ≤ q and bytes exist after it.

    Callers extend the window in the indicated direction and re-check.
    """
    keys = record_keys(kind, raw)
    q = np.asarray(queries, dtype=np.uint64)
    left = (keys[0] > q) & (a > 0)
    right = (keys[-1] <= q) & (b < layer_size)
    return left, right


class SerializedIndex:
    """Handle for Alg.-1 lookups against an index file with partial reads.

    Reads flow through a :class:`repro_torch.serve.StorageBackend`
    (default :class:`~repro_torch.serve.FileBackend`); pass
    ``backend_factory`` to wrap the file in a fault-injecting backend.
    """

    def __init__(self, path: str, backend_factory=None):
        factory = backend_factory or open_file_backend
        self._backend = factory(path)
        self.meta = parse_meta(self._backend.pread)
        self.bytes_read = 0
        self.reads = 0
        root = self.meta.layers[-1] if self.meta.layers else None
        self._root_raw = (self._backend.pread(root.size, root.offset)
                          if root else b"")
        if root:
            self.bytes_read += root.size
            self.reads += 1

    def close(self):
        self._backend.close()

    def lookup(self, query: int) -> tuple[int, int]:
        """→ predicted [lo, hi) byte range in the data layer."""
        metas = self.meta.layers
        if not metas:
            return 0, self.meta.data_size
        q1 = np.asarray([query], dtype=np.uint64)
        lo, hi = predict_from_records(metas[-1].kind, self._root_raw, q1,
                                      metas[-1].end_pos)
        for lm in reversed(metas[:-1]):
            a, b = record_aligned_range(lm.kind, lo, hi, lm.size)
            a, b = int(a[0]), int(b[0])
            while True:
                raw = self._backend.pread(b - a, lm.offset + a)
                self.bytes_read += b - a
                self.reads += 1
                left, right = window_misses(lm.kind, raw, a, b, lm.size, q1)
                if not (left[0] or right[0]):
                    break
                w = gallop_step(lm.kind, a, b)  # toward the covering record
                if left[0]:
                    a = max(a - w, 0)
                else:
                    b = min(b + w, lm.size)
            lo, hi = predict_from_records(lm.kind, raw, q1, lm.end_pos)
        lo = max(int(lo[0]), 0)
        hi = min(max(int(hi[0]), lo + 1), self.meta.data_size)
        return lo, hi


def lookup_serialized(path: str, meta_unused, queries: np.ndarray):
    """One :meth:`SerializedIndex.lookup` per query → (q, 2) int64 ranges."""
    idx = SerializedIndex(path)
    try:
        return np.array([idx.lookup(int(q)) for q in np.asarray(queries)],
                        dtype=np.int64)
    finally:
        idx.close()
