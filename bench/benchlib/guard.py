"""What a run checks about its own process: the modules it must never
load, the card it needs, and the fixed cache directory inside the
checkout that the card's driver caches to."""
from __future__ import annotations

import os
import sys
from pathlib import Path

#: top-level module names a run may not hold: JAX, its libraries, and the
#: JAX package the port was made from.  ``repro_torch`` is another name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the checkout's root (``bench/`` lies in it)
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SRC = ROOT / "src"


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), each compared whole: the part before the first dot."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names}
                  & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> dict:
    """A fixed directory inside the checkout for the one cache a run
    writes outside the program's own build (``build/repro_torch/<hash>``,
    which the program keeps in the checkout itself): the CUDA driver's
    compute cache."""
    return {"CUDA_CACHE_PATH": str(root / "build" / "cuda_cache")}


def prepare_process() -> None:
    """Point the caches into the checkout and put the program's sources
    and the benchmark's library on the path (before torch is imported)."""
    os.environ.update(cache_env())
    for path in (str(SRC), str(BENCH)):
        if path not in sys.path:
            sys.path.insert(0, path)


def card_problem(chips: int) -> str | None:
    """Why this process cannot run a cell that asks for ``chips`` cards,
    or None where it can."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: no CUDA card"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell asks for {chips} cards and {n} are visible"
    return None
