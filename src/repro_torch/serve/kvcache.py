"""Paged KV-cache bookkeeping with an AirTune-tuned page table.

Serving keeps KV pages in a device pool; per-sequence *page tables* map
``logical block → physical page``.  A page table is itself a small
hierarchical index, the same step-function machinery as the paper's
layers; its shape (one flat table or a deeper stack) is chosen by AirTune
against the tier it lives in (the card's memory for on-device tables,
host DRAM when they are offloaded).  The port's copy of the JAX package's
``repro.serve.kvcache``: the same tables, free list and key positions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import PROFILES, KeyPositions, airtune, make_builders

PAGE = 16  # tokens per KV page


@dataclasses.dataclass
class PagedKVCache:
    """Host-side page-pool bookkeeping (the device arrays live with the
    decode step)."""

    n_pages: int
    page_tokens: int = PAGE

    def __post_init__(self):
        self.free = list(range(self.n_pages))[::-1]
        self.tables: dict[int, list[int]] = {}   # seq -> physical pages
        self.lengths: dict[int, int] = {}

    def add_sequence(self, seq_id: int):
        self.tables[seq_id] = []
        self.lengths[seq_id] = 0

    def append_tokens(self, seq_id: int, n: int):
        need = -(-(self.lengths[seq_id] + n) // self.page_tokens) \
            - len(self.tables[seq_id])
        for _ in range(need):
            if not self.free:
                raise MemoryError("KV pool exhausted")
            self.tables[seq_id].append(self.free.pop())
        self.lengths[seq_id] += n

    def release(self, seq_id: int):
        self.free.extend(self.tables.pop(seq_id))
        self.lengths.pop(seq_id)

    # ---- AirIndex over the page mapping ----
    def key_positions(self) -> KeyPositions:
        """(seq<<20|block) → physical page byte ranges (page-record space)."""
        keys, pages = [], []
        for seq, tbl in sorted(self.tables.items()):
            for blk, phys in enumerate(tbl):
                keys.append((seq << 20) | blk)
                pages.append(phys)
        keys = np.asarray(keys, dtype=np.uint64)
        pages = np.asarray(pages, dtype=np.int64)
        order = np.argsort(keys)
        keys, pages = keys[order], pages[order]
        # record = one 8-byte page pointer in the table tier
        lo = pages * 8
        return KeyPositions(keys=keys, lo=lo, hi=lo + 8,
                            weights=np.ones(len(keys)))

    def tune_table(self, tier: str = "hbm", k: int = 3, *,
                   score_backend: str = "cuda", device=None):
        """AirTune the page-table structure for a storage tier; the ranking
        runs on the card unless ``score_backend``/``device`` say
        otherwise."""
        D = self.key_positions()
        builders = make_builders(lam_low=2**5, lam_high=2**14, base=2.0, p=8)
        return airtune(D, PROFILES[tier], builders, k=k,
                       score_backend=score_backend, device=device)

    def modeled_lookup_cost(self, tier: str = "hbm", *,
                            score_backend: str = "cuda",
                            device=None) -> dict:
        """Compare tuned vs flat-table lookup under the tier profile."""
        res = self.tune_table(tier, score_backend=score_backend,
                              device=device)
        D = res.design.data
        flat_cost = float(PROFILES[tier](D.size_bytes))   # read whole table
        return {"tuned_us": res.cost * 1e6, "flat_us": flat_cost * 1e6,
                "design": res.design.describe()}
