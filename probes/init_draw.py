#!/usr/bin/env python3
"""The seeded parameter draw on one card at full width: the wall and the
peak memory of ``init_params(cfg, 0, "cuda")`` (an ``int`` seed: the JAX
package's ``jax.random`` draw, :mod:`repro_torch.models.prng`) against
``init_params(cfg, torch.Generator)`` (the port's own draw), and the
draw's rate by chunk size.

    python3 probes/init_draw.py [--archs qwen3-14b:40,llama4-scout-17b-a16e:12]
                                [--sweep 20,22,24]

``--archs`` names each configuration with the layers it is drawn at
(llama4 at the 12 layers ``chip_smoke.py`` phase 15 holds); ``--sweep``
times 2^27 elements of one draw at chunks of 2^k elements; the
full-width draws take the draw's own chunk on a card
(``prng.CHUNK_CUDA``).  Each seeded draw's largest leaf has its last
chunk held bit for bit against the same elements drawn on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_ELEMENTS = 1 << 27


def sweep(prng, torch, logs) -> None:
    key = prng.split(prng.prng_key(0), 3)[1]
    for k in logs:
        chunk = 1 << k
        prng.normal(key, 0, chunk, "cuda")          # warm the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for a in range(0, SWEEP_ELEMENTS, chunk):
            prng.normal(key, a, chunk, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        print(f"sweep: chunk 2^{k}: {wall / SWEEP_ELEMENTS * 1e9:.3f} ns an "
              f"element ({wall:.3f} s for 2^27), peak temporaries {peak} B "
              f"({peak / chunk:.1f} B an element)", flush=True)


def full_width(api, cfg, prng, torch) -> None:
    for label, init in (("seed 0 (jax.random)", 0),
                        ("torch.Generator", torch.Generator(
                            device="cuda").manual_seed(0))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = api.init_params(cfg, init, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n = sum(p.numel() for p in model.parameters())
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"{cfg.name} at {cfg.n_layers} layers, {label}: {wall:.3f} s "
              f"for {n} elements ({wall / n * 1e9:.3f} ns an element); "
              f"peak {peak} B = parameters {held} B + {peak - held} B",
              flush=True)
        if isinstance(init, int):
            check_last_chunk(model, cfg, prng, torch)
        del model


def check_last_chunk(model, cfg, prng, torch) -> None:
    """The last chunk of the largest leaf's draw, on the card and on the
    CPU, bit for bit."""
    from repro_torch.models.params import _jax_order
    shapes = [(name, shape) for name, shape, _ in _jax_order(model)]
    keys = prng.split(prng.prng_key(0), len(shapes))
    key, (name, shape) = max(zip(keys, shapes),
                             key=lambda kv: _numel(kv[1][1]))
    total = _numel(shape)
    n_last = min(prng.chunk("cuda"), total)
    a = total - n_last
    same = torch.equal(prng.normal(key, a, n_last, "cuda").cpu(),
                       prng.normal(key, a, n_last, "cpu"))
    print(f"{cfg.name}: the last {n_last} elements of {name} "
          f"{tuple(shape)} drawn on the card "
          f"{'equal' if same else 'DIFFER FROM'} the CPU's", flush=True)
    if not same:
        raise AssertionError(f"{name}: the card's draw differs")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs",
                    default="qwen3-14b:40,llama4-scout-17b-a16e:12")
    ap.add_argument("--sweep", default="20,22,24")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import api, prng
    if not torch.cuda.is_available():
        print("init_draw: no CUDA device is available", file=sys.stderr)
        return 1
    print(cs.card_info(), torch.__version__, torch.version.cuda, flush=True)
    if args.sweep:
        sweep(prng, torch, [int(k) for k in args.sweep.split(",")])
    print(f"full-width draws in chunks of {prng.chunk('cuda')} elements",
          flush=True)
    for item in filter(None, args.archs.split(",")):
        arch, layers = item.split(":")
        cfg = get_config(arch).scaled(n_layers=int(layers))
        full_width(api, cfg, prng, torch)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
