#!/usr/bin/env python3
"""rwkv6-7b's decode against its own prefill in float32, over prompts of
several lengths, in the JAX package and in the port on the same
parameters (the JAX package's ``init_params``, carried across with
``params_from_numpy``): the depth of the published config, a narrow
width.  Prints, per prompt length, each package's decode vs its own
prefill and the port against the JAX package for each path, all as the
last logits' max error over max |logit|.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 probes/rwkv_echo_lengths.py \\
        [--layers 32] [--width 256] [--tokens 32 64 128]

CPU only: like the tests, it imports both packages.  At the defaults a
run takes about two minutes.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--width", type=int, default=256,
                    help="d_model, a multiple of the 64-wide wkv heads")
    ap.add_argument("--tokens", type=int, nargs="+", default=[32, 64, 128])
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as jconfigs
    from repro.models import api as japi
    from repro.serve.serve_step import make_decode_step as j_decode_step
    from repro.serve.serve_step import make_prefill_step as j_prefill_step
    from repro_torch import configs as tconfigs
    from repro_torch.models import api
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve import make_decode_step, make_prefill_step

    jax.config.update("jax_default_matmul_precision", "highest")
    d = args.width
    kw = dict(n_layers=args.layers, d_model=d, n_heads=d // 64,
              n_kv_heads=d // 64, d_ff=int(3.5 * d), vocab=4096,
              dtype="float32")
    jc = jconfigs.get_config("rwkv6_7b").scaled(**kw)
    tc = tconfigs.get_config("rwkv6_7b").scaled(**kw)
    jp = japi.init_params(jc, jax.random.PRNGKey(7))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    B = 2
    toks_all = np.random.default_rng(0).integers(
        1, jc.vocab, (B, max(args.tokens))).astype(np.int32)
    jdec, jpre = jax.jit(j_decode_step(jc)), j_prefill_step(jc)
    dec, pre = make_decode_step(tc), make_prefill_step(tc)
    with torch.no_grad():
        for n in args.tokens:
            toks = toks_all[:, :n]
            jw = np.asarray(jpre(jp, {"tokens": jnp.asarray(toks)}),
                            np.float32)[:, :jc.vocab]
            tw = pre(tp, {"tokens": torch.from_numpy(toks)}).float() \
                .numpy()[:, :jc.vocab]
            js = japi.init_decode_state(jc, jp, B, n)
            ts = api.init_decode_state(tc, tp, B, n)
            for t in range(n):
                jg, js = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                              js, t)
                tg, ts = dec(tp, {"tokens": torch.from_numpy(
                    toks[:, t:t + 1])}, ts, t)
            jg = np.asarray(jg, np.float32)[:, :jc.vocab]
            tg = tg.float().numpy()[:, :jc.vocab]
            print(f"rwkv6 at {args.layers} layers, d_model {d}, float32, "
                  f"{B} x {n}: decode vs prefill, JAX {rel(jg, jw):.3e}, "
                  f"port {rel(tg, tw):.3e}; port vs JAX, prefill "
                  f"{rel(tw, jw):.3e}, decode {rel(tg, jg):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
