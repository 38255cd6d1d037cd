#!/usr/bin/env python3
"""Drive the PyTorch port's serving, tuning, in-memory lookup, LLM serving,
training, multi-device and dry-run paths on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--draws 230000000]
                          [--tune-draws 21000000]

Phases (none catches its own failure; any failure exits non-zero), run in
the order 1, 2, 3, 4, 5, 10, 6, 7, 8, 9, 13, 11, 14, 15, 16, 17, 12:

1. Card: name and power limit from ``nvidia-smi``.
2. Build: compile all seven kernels from ``src/repro_torch/csrc`` through
   the shared build helper, one ``nvcc`` per source, all started
   together; print each kernel's ptxas registers, shared memory and
   spills; count the ``HGMMA`` instructions of the flash library and the
   ``HMMA`` of the decode library in ``cuobjdump -sass`` (fails on 0; a
   toolkit without ``cuobjdump`` is reported on a line).
3. Fused descent against its plain version: random packed prefixes (L in
   1/2/3/4, step-only and mixed, P in 128/640/1664/4096, Q in
   1/255/256/4097/65536); the kernel must equal ``fused_descent_torch`` on
   the card bit for bit, the engine's staged ``FusedDescent.descend`` must
   equal the kernel, step rows must equal the float64 walk and band rows
   must contain it.
4. Candidate scoring against its plain version: C in 1/7/8/39/300, S in
   1/127/128/4097/65536/65574/131072 (every S mod 4), W ~ U[16, 1e6],
   weights ~ U[0.5, 4], under the affine coefficients of azure_ssd,
   azure_nfs, a 50%-hit CachedProfile over azure_ssd and a p99 (w = 1)
   ObjectiveProfile over azure_ssd; the kernel must match
   ``affine_scores_torch`` to rtol 1e-5 and the float64 oracle to rtol
   3e-5, and a second launch must equal the first bit for bit.
5. The index-lookup kernels against their plain versions: step layers of
   P in 1/2/31/32/33/64/127/128/1000/4095/4096, band layers of P in
   1/10/171/300/723/1024/1025/4096, two-level step layers of P in
   4097/4224/4225/20000/81000/823133 and at the widths whose grid (one
   key in 128) just fits and just overflows a block's shared memory, each
   at Q in 1/255/256/257/4096/4097/65536/2^20 (queries below the first key, at
   the last, above it, 2^31 - 1 and every grid key among them); every
   kernel must equal its plain version bit for bit (the segmented kernel,
   which runs both levels, the plain ``segment_bases`` +
   ``segmented_step_lookup_torch``), and step and segmented rows the
   float64 ``layer.predict``.
6. The serving path at a deployment's size: ~200 M unique int32-domain
   keys from the paper's §7.1 100-cluster Gaussian mixture, 16-byte
   records, a gstep(8, 4096) <- gband(1024) <- gstep(8, 4096) index
   written paged with CRCs, served by ``IndexService`` on the card (two
   resident layers, a 1 MiB + 8 MiB block cache, a two-deep prefetch
   pipeline) over a uniform and a Zipf(1.1) stream of 96 batches x 4096
   keys (256 before phase 14 took their time, 128 before phase 15).  Every range must contain its key's record, equal the numpy
   backend's ranges, and a 2,000-key sample must equal
   ``SerializedIndex.lookup``.
7. The tuning path: ~14 M keys of the same mixture (cut from ~200 M by the
   run's time limit).  Generation 0 of phase 8 is
   ``Index.tune(D, "azure_ssd", TuneSpec(k=5, page_bytes=4096)).build()``,
   the run's one cold build; its retained ``LayerCache`` serves the
   other tunes: ``airtune(k=5)`` and ``beam_search(k=5)`` over the
   default builders for azure_ssd, azure_nfs and azure_hdd, and
   ``airtune`` with the p99 (w = 1) objective on azure_ssd, each ranking
   on the card; each again with ``score_backend="numpy"``, whose cost
   must agree to rel 1e-6.  Generation 0 is saved paged and 64 batches x
   4096 uniform keys are served from it on the card with every layer
   that packs resident: ranges must contain their records and equal the
   numpy backend's.
8. The facade's loop: generation 0 reopened and served on azure_hdd with
   persisted stats (64 batches x 4096 keys); ``observe`` must say
   "retune" and ``detect_drift_from_file`` agree; a warm retune for the
   observed profile must equal its numpy-ranked twin's design and cost
   and reuse layers; generation 1 is saved and swapped in while a
   pipelined stream runs in a second thread: every batch must equal one
   generation's ranges and ``stats.swaps`` must be 1.
9. The in-memory Alg. 1: ``traverse_index`` on the card over the same
   keys for both generations and a gstep(8, 4096) <- gband(1024) <-
   gstep(8, 4096) design (step, band and segmented kernels), over a
   uniform stream of 256 batches x 4096 keys and one 2^20-key batch:
   every range must contain its record, step bottoms must equal the
   float64 ``lookup_batch``, band bottoms are compared with it; exactly
   one launch a layer and batch; each batch's host split (int32 cast,
   copy in, each layer's call, copy out, widening).  The two-level layer
   call must launch its kernel once and nothing else (20 calls counted,
   one traced).  Every lookup kernel is timed at the stream's batch and
   at 2^20 keys: the step kernel at the top layer (P = 2) and at a
   4,096-wide layer, the band also at generation 0's width.
10. The attention kernels against their plain versions: decode at
   (query, kv) heads 40/8, 32/2 and 8/8, D in 128/64, S in
   1/127/128/4096/32768 with per-row lengths from 1..S and one row of
   length 0, in bf16 and f32, and the bf16 kernel at groups
   1/4/5/8/16, D in 32/64/128, S in 1/63/64/65/4096/32768 (ragged, one
   row of length 0, one at S); flash attention over the JAX kernel
   tests' cases, qwen3-14b's heads at Sq = Skv = 4096 and Sq < Skv, in
   bf16 and f32, and the bf16 kernel at its tile edges (Sq in
   1/63/64/65/95/96/97/127/128/129/191/192/193/255, Skv - Sq in 0/1/200,
   D in 32/64/128) and with window and softcap together at 1,000 tokens;
   decode with gemma2's heads (32/16 of 128), window 4,096 and softcap 50
   at caches 1/4095/4097/32768, f32 and bf16, and its bf16 time at
   B = 8 x 32768 against the bound over the 4,096 live keys; several new
   tokens a step, folded into group x Sq query rows: qwen3-14b's heads
   (40/8) at Sq = 4 (20 rows, two m-tiles: phases 11 and 15's rows),
   glm4's (32/2) at Sq = 4 (64 rows, a whole row tile), deepseek's (56/8) at Sq = 10
   (70 rows, two tiles) and gemma2's (32/16, window 4,096, softcap 50) at
   Sq = 8, caches 1/4095/32768, f32 and bf16, and the bf16 kernel timed
   at qwen3-14b's heads (B = 4, cache 4,096) for Sq = 1, 4 and 8 beside
   its bound and SDPA with a length mask.
   Limits: f32 at the JAX tests' own (flash 2e-5; decode 3e-5 on o, 1e-5
   on m, l relative 1e-5), with TF32 off for the plain versions; bf16
   2e-2.
11. The LLM serving path, after the index phases with the card's memory
   freed: the ``h100_hbm`` profile's ℓ and B measured (4 KiB copies
   queued back to back, 2 GiB copies; CUDA events) and held within 2x of
   the profile; qwen3-14b at
   full width in bf16 and 8 of its 40 layers (40 before phase 15 took
   the time), weights from ``init_params`` on the card;
   ``make_prefill_step`` at B = 1 x 4096 and B = 4 x 2048 (twice each);
   the port's ``launch.serve.run`` with 8 requests, batch 4, and the steps
   every request needs; one 4 x 512 prompt through prefill and, token by
   token, decode, whose last logits must agree within 5e-2 of max |logit|
   (top-1 equal where prefill's top-2 margin is larger), then 4 new tokens
   in one decode step, whose last token's logits must agree in the same
   way with a prefill of all 516 (the new tokens see each other with no
   mask, as in the JAX package, so from the second layer on the earlier
   ones' K/V differ from prefill's; over a 512-token cache that moves the
   last logits well inside the limit); a profiled decode step and prefill
   (device busy share).  Exactly one flash
   launch a layer and prefill call and one decode launch a layer and
   decode step, and
   no plain attention runs; the path's peak memory; then the page table of
   the loop's requests tuned for ``h100_hbm`` on the card.  The phase runs
   under ``torch.no_grad()``: serving builds no autograd graph.
14. The training path, after phase 11 with its model freed: a token
   store of 2^18 records (64..511 tokens each, token ranks drawn by
   Zipf's law over qwen3's vocab) written and opened on azure_ssd (its
   sample index tuned by AirTune), 1,024 random ``get``s equal to their
   records; ``FlashAttention`` at the training shape (B = 4, S = 512,
   40/8 heads of 128, bf16, causal) against the plain version in float32:
   its output (the flash kernel) within the bf16 flash limit 2e-2, and
   its dq, dk, dv within 2e-2 of max |grad| of autograd through the plain
   version; then the port's
   ``launch.train.run`` on qwen3-14b at full width, 14 of its 40 layers,
   bf16, remat, batch 4 x 512, the default AdamW, 12 steps with a
   checkpoint every 6, a host killed after step 8 so the supervisor
   restores the step-6 checkpoint (every restored leaf's sha1 equal to
   the saved tree's) and replays: exactly 2 flash launches a layer and
   step call (the forward and the remat recompute), no plain attention,
   finite losses that fall (the launcher's own assertion); step call 2 is
   traced for the device busy share and its top kernels.
15. The other families, after phase 14 with its model freed, under
   ``torch.no_grad()`` in bf16, weights from ``init_params`` on the card:
   llama4-scout-17b-a16e (16 experts top-1 + a shared expert; 12 of its
   48 layers), grok-1-314b (8 experts top-2; 4 of 64), llava-next-34b (all
   60 layers, 576 patch embeddings at random positions), zamba2-1.2b (38
   mamba layers, the shared block after every 6), rwkv6-7b (32 layers) and
   whisper-small (12 + 12 layers over 1,500 stub frames), each at its
   published width: ``make_prefill_step`` twice at 1 x 4096 (whisper at
   its 448-token context) and once instrumented (MoE capacity drops; each
   chunked scan's wall and the largest |W| a chunk's cumulative
   log-decay reaches); one 2 x 128 prompt through prefill and, token by
   token, decode, whose last logits must agree within 5e-2 of max |logit|
   (top-1 equal where prefill's top-2 margin is larger): MoE at the
   capacity factor E / k, where nothing is dropped, its routing flips
   between the two paths counted and the check decided with decode routed
   as prefill routed; rwkv6 decided in float32 (the same weights upcast),
   its bf16 error printed; llava text-only; llama4 (routed as prefill
   routes) and whisper then decode 4 new tokens in one step, checked as
   phase 11 checks them against a prefill of 132 tokens.  zamba2 also runs the port's
   ``launch.serve`` loop at the JAX launcher's defaults (8 requests, batch
   4, 32 steps).  Exact flash and decode launches per family, no plain
   attention; each family's peak memory.
16. The multi-device slice on the one card, after phase 15 with its
   models freed: (a) qwen3-14b's decode at full width (40/8 heads of
   128, bf16), B = 8, a 32,768-token cache held as 4 contiguous sequence
   shards, each shard's partial from the decode kernel and the four
   combined by ``combine_partials``, at lengths 32,768, 32,751, 9,000
   (two shards empty) and 1: within 2e-2 of max |plain| of the unsharded
   kernel and of the plain version, each shard's partial within 2e-2 of
   its plain version, and three controls that must fail that bound (the
   combine without its max-correction, a live shard's partial zeroed, a
   shard's partial without its last 64 keys); an empty shard's partial
   m = -1e30, l = 0, exactly 4 launches a length and no plain decode;
   one shard's kernel time and the combine's, L2-cold (CUDA events);
   (b) a 1-rank NCCL group (``file://`` rendezvous):
   ``flash_decode_sharded`` at the same lengths against the unsharded
   kernel (2e-2 of its max |o|), and ``compressed_psum``
   over qwen3-14b's tree at full width and 2 layers for 30 steps of one
   random gradient: the int8 error of each leaf within scale/127 and the
   error-feedback mean within 0.02 relative of the gradient (the bounds of
   tests/test_substrates.py).  Its decode launches add to the decode
   row of the kernels line.
17. The meta-device dry run (``repro_torch.launch.dryrun``), after phase
   16: phase 14's training step (qwen3-14b, 14 layers, 4 x 512) and phase
   11's prefill (8 layers, 1 x 4096) and decode (4 over a 512 cache)
   traced on ``meta`` on a 1x1 mesh; one such training step and one such
   prefill run on the card after ``reset_peak_memory_stats``: the
   predicted ``argument_bytes`` must be within 20% of the bytes the step's
   arguments made live, and ``temp_bytes`` within 20% of the rise of
   ``max_memory_allocated`` above them; the counted training dot FLOPs
   must reach the model FLOPs (6 N tokens + attention's) and their ratio
   is printed; and the qwen3-14b row of ``python -m
   repro_torch.launch.dryrun --mesh both``, run on the host's CPU with
   the card hidden, must give 6 ok and 2 skipped records, each printed.
13. The sharded fleet on the card, after phase 9: the tuning phase's keys
   with 1 KiB records (the record size of the JAX package's fleet
   scenario, benchmarks/serve_bench.py:383) as 4 key-range shards, each
   tuned on the card with the default λ grid (``Fleet.tune(D,
   "azure_ssd", FleetSpec(n_shards=4, tune=TuneSpec(k=5,
   page_bytes=4096), serve=ServeSpec(persist_stats=True),
   cache_budget_bytes=B)).build()``, B half the shards' cacheable
   working sets together), saved, reopened with ``Fleet.open(dir,
   data=D)`` and served on the card over a uniform and a Zipf(1.1)
   stream of 64 batches x 4096 keys through ``lookup_batches``: every
   range must contain its record and equal a numpy-backend
   ``FleetService``'s, a 2,000-key sample must equal ``Fleet.lookup``,
   exactly one ``fused_descent`` launch a non-empty shard sub-batch and
   no plain descent; a shard whose disk dies after open must raise
   ``ShardUnavailableError``, and ``partial_results=True`` must mask
   exactly its keys and leave the others unchanged.
12. Numbers: each phase's wall; sizes, build/generation times, per-stream
   qps, lookup wall, descent seconds, roofline and hit rate; the fleet's
   tune and save walls, lookups/s a stream, each shard's hit rate and
   descent seconds and the cache plans; the wall per
   call of the engine's descent and of the one library call inside it
   (inside each pipelined stream and alone); per tune its wall, sweep
   seconds, stats and the device ranking's copy/kernel/readback split;
   the loop's walls and drift report; ``traverse_index`` lookups/s and
   batch walls; each kernel's time per launch beside its plain version,
   its bound and, where one exists, a PyTorch yardstick; every time in
   the kernels line is taken with the L2 flushed before each call;
   prefill tokens/s and wall, decode tokens/s and step walls, and each
   attention kernel at the path's shapes (and decode at B = 8, S = 32768)
   beside its plain version, the
   ``scaled_dot_product_attention`` yardstick and its bound, with its
   achieved TFLOP/s and GB/s; the training step's wall (mean, median),
   tokens/s, model TFLOP/s, peak memory, device busy share and top
   kernels, and the checkpoint save and restore walls and bytes.  The fused descent, candidate scoring and
   the attention kernels are timed with CUDA events around calls queued
   behind a device sleep, the lookup kernels from CUPTI traces (a trace
   now and then loses device records).

The second-to-last line is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "src/repro_torch/csrc/fused_descent.cu"
LOOKUP_KERNELS = {                  # name -> (source, the TPU kernel it replaces)
    "step_lookup": ("src/repro_torch/csrc/step_lookup.cu",
                    "src/repro/kernels/index_lookup/kernel.py:67"),
    "band_lookup": ("src/repro_torch/csrc/band_lookup.cu",
                    "src/repro/kernels/index_lookup/kernel.py:104"),
    "segmented_step_lookup": (
        "src/repro_torch/csrc/segmented_step_lookup.cu",
        "src/repro/kernels/index_lookup/kernel.py:136"),
}
LOOKUP_STEP_P = (1, 2, 31, 32, 33, 64, 127, 128, 1000, 4095, 4096)
# band widths: phase 9's two (171, 723) and the parameter-staging edge
LOOKUP_BAND_P = (1, 10, 171, 300, 723, 1024, 1025, 4096)
# two-level widths: past the cap, a 33rd segment of 1 and of 2 keys
# (4224 = 33 x 128), ~the 20.8 M-key bottom layer, phase 6's; phase 5 adds
# the widths whose grid just fits and just overflows a block's shared memory
LOOKUP_SEG_P = (4097, 4224, 4225, 20_000, 81_000, 823_133)
LOOKUP_Q = (1, 255, 256, 257, 4096, 4097, 65536, 1 << 20)
LOOKUP_BIG_Q = 1 << 20           # phase 9's second batch size
LOOKUP_WIDE_STEP_P = 4096        # phase 9's second step width (phase 5's widest)
LOOP_BATCHES = 64
KERNEL_REPLACES = "src/repro/kernels/fused_descent/kernel.py:96"
SCORE_SOURCE = "src/repro_torch/csrc/candidate_score.cu"
SCORE_REPLACES = "src/repro/kernels/candidate_score/kernel.py:34"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
RECORD_BYTES = 16
N_BATCHES = 256                  # phase 9's stream
SERVE_BATCHES = 96               # phase 6's streams (256 before phase 14,
                                 # 128 before phase 15)
BATCH = 4096
ZIPF_A = 1.1
DRAWS = 230_000_000              # ~200 M unique keys: the SOSD scale
TUNE_DRAWS = 14_000_000          # ~14 M unique keys: the tuning phase
                                 # (~20 M before phase 14 took its time)
TUNE_TIERS = ("azure_ssd", "azure_nfs", "azure_hdd")
P99 = {"p": 0.99, "weight": 1.0}
TUNE_BATCHES = 64
FLEET_SHARDS = 4
FLEET_K = 5                      # each shard's Alg. 2 beam
FLEET_BATCHES = 64
# the record size of the JAX package's fleet scenario
# (benchmarks/serve_bench.py:376-383): 1 KiB records put each shard's
# optimum at two layers with a disk-resident bottom layer, where a cache
# budget is a real resource (at 16-byte records every 5.2 M-key shard
# tunes to one resident band layer: no read to cache)
FLEET_RECORD = 1024
SCORE_RTOL_PLAIN = 1e-5          # kernel vs plain float32 (sum order)
SCORE_RTOL_REF = 3e-5            # kernel vs float64 oracle (the JAX
                                 # package's tolerance for its scorers)
ATTN_KERNELS = {                 # name -> (source, the TPU kernel it replaces)
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:73"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:90"),
}
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
DECODE_PAIRS = ((40, 8), (32, 2), (8, 8))    # (query heads, kv heads)
DECODE_D = (128, 64)
DECODE_S = (1, 127, 128, 4096, 32768)
DECODE_B = 4
# tests/test_kernels.py's ATTN_CASES, qwen3-14b's heads at 4096, Sq < Skv
FLASH_CASES = (
    dict(B=2, Hq=4, Hkv=4, Sq=128, Skv=128, D=64),
    dict(B=1, Hq=8, Hkv=2, Sq=128, Skv=128, D=64),
    dict(B=2, Hq=4, Hkv=2, Sq=96, Skv=96, D=64),
    dict(B=1, Hq=4, Hkv=4, Sq=128, Skv=128, D=64, window=32),
    dict(B=1, Hq=4, Hkv=4, Sq=128, Skv=128, D=64, softcap=30.0),
    dict(B=1, Hq=4, Hkv=2, Sq=64, Skv=192, D=64),
    dict(B=1, Hq=4, Hkv=4, Sq=100, Skv=228, D=32, window=50),
    dict(B=1, Hq=2, Hkv=1, Sq=128, Skv=128, D=128, window=64, softcap=50.0),
    dict(B=1, Hq=40, Hkv=8, Sq=4096, Skv=4096, D=128),
    dict(B=2, Hq=40, Hkv=8, Sq=1000, Skv=3000, D=128),
    # whisper's non-causal attention (12 heads of 64): the encoder, the
    # decoder's cross-attention at its context, at Sq = 1 (decode) and past
    # the encoder's length (Sq > Skv: SMOKE's 32 frames, train_4k's 4,096
    # tokens over 1,500), and ragged tile edges past Skv
    dict(B=1, Hq=12, Hkv=12, Sq=1500, Skv=1500, D=64, causal=False),
    dict(B=1, Hq=12, Hkv=12, Sq=448, Skv=1500, D=64, causal=False),
    dict(B=2, Hq=12, Hkv=12, Sq=1, Skv=1500, D=64, causal=False),
    dict(B=2, Hq=12, Hkv=12, Sq=448, Skv=32, D=64, causal=False),
    dict(B=1, Hq=12, Hkv=12, Sq=4096, Skv=1500, D=64, causal=False),
    dict(B=2, Hq=4, Hkv=2, Sq=129, Skv=95, D=32, causal=False),
    dict(B=1, Hq=4, Hkv=4, Sq=300, Skv=1, D=128, causal=False,
         softcap=30.0),
)
# the bf16 kernels' tile edges (as tests/test_torch_kernel_cuda.py): flash
# Sq x (Skv - Sq) x D at 2 query and 4 kv heads, B = 2; window and softcap
# together at 1,000 tokens; decode groups x D x S at B = 4, 2 kv heads
FLASH_EDGE_SQ = (1, 63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 192, 193,
                 255)
FLASH_EDGE_EXTRA = (0, 1, 200)
EDGE_D = (32, 64, 128)
FLASH_WINDOWED = (
    dict(B=1, Hq=4, Hkv=2, Sq=1000, Skv=1000, D=128, window=300,
         softcap=30.0),
    dict(B=2, Hq=4, Hkv=4, Sq=1000, Skv=1000, D=64, window=129,
         softcap=50.0),
)
DECODE_GROUPS = (1, 4, 5, 8, 16)
DECODE_EDGE_S = (1, 63, 64, 65, 4096, 32768)
# gemma2's decode: its real heads (32 query, 16 kv, D = 128), window 4,096
# and attention softcap 50 (configs/gemma2_27b.py), at caches below, at and
# past the window
WINDOW_ARCH = "gemma2-27b"
WINDOW_CACHES = (1, 4095, 4097, 32768)
# kernel vs plain: float32 at the JAX kernel tests' own limits (flash 2e-5,
# decode 3e-5 on o and 1e-5 on m; l relative), bfloat16 at 2e-2
ATTN_TOL = {"float32": {"flash": 2e-5, "o": 3e-5, "m": 1e-5, "l": 1e-5},
            "bfloat16": {"flash": 2e-2, "o": 2e-2, "m": 2e-2, "l": 2e-2}}
LLM_ARCH = "qwen3-14b"
LLM_LAYERS = 8                   # phase 11's depth of 40 (phase 15's time)
PREFILLS = ((1, 4096), (4, 2048))          # (batch, prompt length)
SERVE_REQUESTS = 8
SERVE_BATCH = 4
ECHO_BATCH, ECHO_LEN = 4, 512    # the prompt fed through prefill and decode
# decode's last logits vs prefill's, over max |logit|: the two paths round
# bf16 activations at other places (matmul shapes, attention order)
ECHO_TOL = 5e-2
SHARE_STEPS = 5                  # decode steps traced for the busy share
HBM_SMALL = 4096                 # bytes of the latency copy
HBM_LARGE = 2 << 30              # bytes of the bandwidth copy
HBM_FACTOR = 2.0                 # measured vs the "h100_hbm" profile, at most
SLEEP_CYCLES = 100_000_000       # device sleep the timed calls queue behind
QUEUED_CALLS = 20                # calls queued at once where a trace fails
# phase 14: qwen3-14b at full width, its depth cut to what one card holds
# with bf16 weights and gradients and float32 moments, trained through the
# port's launcher with a restore
TRAIN_LAYERS = 14                # the deepest that fits an 80 GB H100
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 6
TRAIN_KILL_AFTER = 8             # a host dies after this step
TRAIN_TRACED = 2                 # the step call traced for the busy share
STORE_SAMPLES = 1 << 18          # token records of the phase's store
STORE_LENGTHS = (64, 512)        # a record's tokens: 64..511
TOKEN_ZIPF = 1.0                 # token ranks drawn by Zipf's law
STORE_GETS = 1024
GRAD_TOL = 2e-2                  # attention gradients vs plain autograd
# phase 15: the other families at their published widths, each depth cut
# only where one card's memory or the run's time limit asks
FAMILIES = (                     # (arch, layers kept; None: full depth)
    ("llama4-scout-17b-a16e", 12),
    ("grok-1-314b", 4),
    ("llava-next-34b", None),
    ("zamba2-1.2b", None),
    ("rwkv6-7b", None),
    ("whisper-small", None),
)
FAMILY_PREFILL = 4096            # tokens of the 1 x S prefill
WHISPER_CONTEXT = 448            # whisper's decoder context
FAMILY_ECHO = (2, 128)           # the prompt through prefill and decode
# families whose decode check is decided in float32 (the bf16 weights
# upcast): random-weight RWKV6 amplifies bf16 rounding over its 32 layers
# (PERF.md §6), so bf16 cannot hold its chunked scan to its recurrence
ECHO_F32_FAMILIES = ("ssm",)
# several new tokens a step: (arch, new tokens) of phase 10's kernel
# checks -- qwen3-14b's 5 query heads a kv head x MULTI_NEW = 20 rows (two
# m-tiles, the rows phases 11 and 15 give the kernel), glm4's 16 x 4 = 64
# (a whole row tile), deepseek's 7 x 10 = 70 (two tiles), gemma2's 2 x 8
# with its window and softcap -- the new tokens of phases 11 and 15's
# check, the families phase 15 checks it on, and the Sq phase 10 times at
# qwen3's heads
MULTI_CASES = (("qwen3-14b", 4), ("glm4-9b", 4), ("deepseek-coder-33b", 10),
               ("gemma2-27b", 8))
MULTI_S = (1, 4095, 32768)
MULTI_NEW = 4
MULTI_FAMILIES = ("llama4-scout-17b-a16e", "whisper-small")
MULTI_TIMED = (1, 4, 8)
MULTI_TIMED_B, MULTI_TIMED_S = 4, 4096
# phase 17: the dry run's prediction of the card's bytes, at most this far
# off (relative); the qwen3-14b row of the dry run at both meshes
DRY_TOL = 0.20
DRY_ARCH = "qwen3_14b"
DIST_SHARDS = 4                  # phase 16's sequence shards
DIST_B, DIST_S = 8, 32768        # phase 16's decode batch and cache
DIST_LENGTHS = (DIST_S, DIST_S - 17, 9000, 1)   # 9,000: two shards empty
DIST_TOL = 2e-2                  # bf16, the decode checks' bound, of max |plain|
DIST_DROP = 64                   # keys a control drops from a shard's end
DIST_LAYERS = 2                  # the compressed tree's depth
DIST_STEPS = 30                  # error-feedback steps (tests/test_substrates.py)
DIST_EF_TOL = 0.02               # its bound on the mean's relative error


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------
def random_prefix(rng, L: int, P: int, mixed: bool) -> list:
    """A top-down prefix of parsed layer dicts (the engine's resident form)
    whose packed width is exactly P; every layer starts at key 1, so all
    queries in [1, 2^31-2) lie in its domain."""
    layers = []
    for l in range(L):
        n = int(rng.integers(max(P - 127, 1), P + 1))
        keys = np.unique(rng.integers(2, 2**31 - 2, 3 * n + 8))
        keys = np.sort(rng.choice(keys, n - 1, replace=False))
        keys = np.concatenate([[1], keys]).astype(np.uint64)
        if mixed and (l % 2 == 1 or L == 1):
            layers.append({
                "kind": "band", "x1": keys,
                "y1": np.sort(rng.integers(0, 2**27, n)).astype(np.float64),
                "m": rng.uniform(0.0, 0.5, n),
                "delta": rng.uniform(1.0, 600.0, n)})
        else:
            pos = np.sort(rng.integers(0, 2**30, n + 1))
            layers.append({"kind": "step", "keys": keys,
                           "pos_lo": pos[:-1].astype(np.int64),
                           "pos_hi": pos[1:].astype(np.int64)})
    return layers


def check_kernel(device, seed: int) -> float:
    """Every tested shape: kernel == plain version bit for bit; step rows
    == float64 walk; band rows contain it.  Returns the max |kernel −
    plain| seen (0 when the check passes)."""
    import torch

    from repro_torch.kernels.fused_descent import (FusedDescent,
                                                   fused_descent_ref,
                                                   fused_descent_torch,
                                                   pack_prefix)
    rng = np.random.default_rng(seed)
    n_cases = 0
    max_err = 0
    for L in (1, 2, 3, 4):
        for mixed in (False, True):
            for P in (128, 640, 1664, 4096):
                layers = random_prefix(rng, L, P, mixed)
                planes = pack_prefix(layers)
                assert planes is not None and planes["keys"].shape == (L, P)
                mod = FusedDescent(planes, device=device)
                for Q in (1, 255, 256, 4097, 65536):
                    q = rng.integers(1, 2**31 - 2, Q).astype(np.uint64)
                    qt = torch.from_numpy(q.astype(np.int32)).to(device)
                    klo, khi = mod(qt)
                    plo, phi = fused_descent_torch(mod.planes(), qt)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    err = max(int((klo - plo).abs().max()),
                              int((khi - phi).abs().max()))
                    max_err = max(max_err, err)
                    if not (torch.equal(klo, plo) and torch.equal(khi, phi)):
                        raise AssertionError(
                            f"kernel != plain at L={L} mixed={mixed} P={P} "
                            f"Q={Q}: max |diff| {err}")
                    rlo, rhi = fused_descent_ref(layers, q)
                    klo = klo.cpu().numpy().astype(np.float64)
                    khi = khi.cpu().numpy().astype(np.float64)
                    # the engine's staged path: the same windows
                    slo, shi = mod.descend(q)
                    if not (np.array_equal(slo, klo)
                            and np.array_equal(shi, khi)):
                        raise AssertionError(
                            f"FusedDescent.descend != kernel at L={L} "
                            f"mixed={mixed} P={P} Q={Q}")
                    for r in range(L):
                        if planes["kinds"][r] == 0:
                            ok = (np.array_equal(klo[r], rlo[r])
                                  and np.array_equal(khi[r], rhi[r]))
                        else:
                            ok = (np.all(klo[r] <= rlo[r])
                                  and np.all(khi[r] >= rhi[r]))
                        if not ok:
                            raise AssertionError(
                                f"kernel row {r} ({'band' if planes['kinds'][r] else 'step'})"
                                f" disagrees with the float64 walk at L={L} "
                                f"mixed={mixed} P={P} Q={Q}")
                    n_cases += 1
    log(f"kernel check: {n_cases} shapes (L = 1-4), kernel == plain bit "
        f"for bit, the staged FusedDescent.descend == kernel, step rows == "
        f"float64 walk, band rows contain it")
    return float(max_err)


# ---------------------------------------------------------------------------
# phase 6: the serving path at a deployment's size
# ---------------------------------------------------------------------------
def make_keys(draws: int, seed: int) -> np.ndarray:
    """The paper's §7.1 100-cluster Gaussian mixture inside the int32 key
    domain the kernel admits: centres U[2^26, 2^31-2^27), sigma
    U[2^21, 2^24), draws kept in [1, 2^31-2), deduplicated → sorted uint64."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(2**26, 2**31 - 2**27, 100)
    sigmas = rng.uniform(2**21, 2**24, 100)
    counts = rng.multinomial(draws, np.full(100, 0.01))
    x = np.empty(draws, dtype=np.float64)
    s = 0
    for c, sd, k in zip(centres, sigmas, counts):
        x[s:s + k] = rng.normal(c, sd, k)
        s += k
    keys = x[(x >= 1.0) & (x < 2.0**31 - 2)].astype(np.int64)
    del x
    # sort + neighbour mask rather than np.unique: numpy 2.3 runs unique
    # through a hash table, orders of magnitude slower than a sort on
    # ~10^8 distinct keys
    keys.sort()
    first = np.empty(len(keys), dtype=bool)
    first[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    return keys[first].astype(np.uint64)


def build_design(keys: np.ndarray):
    """gstep(p=8, λ=4096) <- gband(λ=1024) <- gstep(p=8, λ=4096), built
    bottom-up with the port's builders (the band falls back to λ=2048 if it
    comes out wider than one kernel plane)."""
    from repro_torch.core import (IndexDesign, KeyPositions, build_gband,
                                  build_gstep, outline)
    from repro_torch.kernels.fused_descent import MAX_VMEM_ENTRIES
    D = KeyPositions.fixed_record(keys, RECORD_BYTES)
    l1 = build_gstep(D, 8, 4096)
    o1 = outline(l1, D)
    l2 = build_gband(o1, 1024)
    if l2.n_nodes > MAX_VMEM_ENTRIES:
        log(f"band layer has {l2.n_nodes} nodes > {MAX_VMEM_ENTRIES}: "
            f"rebuilding it with λ=2048")
        l2 = build_gband(o1, 2048)
    l3 = build_gstep(outline(l2, o1), 8, 4096)
    return IndexDesign(layers=(l1, l2, l3), data=D)


def make_streams(n_keys: int, seed: int, n_batches: int, batch: int) -> dict:
    """Key-index streams: uniform over the stored keys (Eq. 6's query
    distribution) and Zipf(1.1) over key ranks, with ranks scattered over
    the key space by a multiplicative bijection."""
    rng = np.random.default_rng(seed + 1)
    total = n_batches * batch
    uniform = rng.integers(0, n_keys, total)
    ranks = (rng.zipf(ZIPF_A, total) - 1) % n_keys
    mult = 2654435761                       # prime; bijective mod n_keys
    while math.gcd(mult, n_keys) != 1:
        mult += 2
    zipf = (ranks.astype(np.int64) * mult) % n_keys
    return {"uniform": uniform, "zipf": zipf}


def serve_stream(path: str, keys: np.ndarray, idx: np.ndarray, spec,
                 device, n_batches: int) -> tuple:
    """One cold service over one stream → (ranges (n, 2), report, the
    ``FusedDescent`` module that served it or None).  The service is
    closed before returning."""
    from repro_torch.serve import IndexService
    batches = np.split(keys[idx], n_batches)
    svc = IndexService(path, spec=spec, device=device)
    try:
        t0 = time.perf_counter()
        out = svc.lookup_batches(batches)
        wall = time.perf_counter() - t0
        st = svc.stats
        walls = np.asarray([w for _, w in st.lookup_samples])
        assert len(walls) == n_batches, (len(walls), n_batches)
        report = {
            "lookups": int(st.queries), "batches": int(st.batches),
            "wall_seconds": wall, "qps": st.queries / wall,
            "lookup_wall_samples": len(walls),
            "lookup_wall_mean_s": float(walls.mean()),
            "lookup_wall_median_s": float(np.median(walls)),
            "lookup_wall_p95_s": float(np.quantile(walls, 0.95)),
            "lookup_wall_p99_s": float(np.quantile(walls, 0.99)),
            "descent_seconds_per_batch": st.descent_seconds / st.batches,
            "roofline": st.roofline(), "hit_rate": st.hit_rate,
            "device_batches": int(st.device_batches),
            "device_active": bool(svc.device_active),
            "preads": int(st.preads)}
        fused = svc._st.fused
    finally:
        svc.close()
    return np.concatenate(out), report, fused


def check_ranges(ranges: np.ndarray, idx: np.ndarray, name: str,
                 record: int = RECORD_BYTES) -> None:
    assert ranges.shape == (len(idx), 2) and ranges.dtype == np.int64, \
        (ranges.shape, ranges.dtype)
    rec = record * idx.astype(np.int64)
    bad = ~((ranges[:, 0] <= rec) & (ranges[:, 1] >= rec + record))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{name}: {int(bad.sum())} ranges miss their "
                             f"record, first at key index {int(idx[i])}: "
                             f"{ranges[i].tolist()}")


def time_launches(fn, n: int, reps: int) -> float:
    """Median over ``reps`` of CUDA-event time per call for ``n``
    back-to-back calls of ``fn`` → milliseconds per call."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        per.append(e0.elapsed_time(e1) / n)
    return float(np.median(per))


def trace_device_us(fn, n: int, before=None, attempts: int = 6) -> dict:
    """Device time of ``n`` calls of ``fn`` (each after ``before()``, when
    given) from the profiler's CUPTI trace → microseconds per device row
    (kernel or copy) name, summed over the calls.  An operator's row
    repeats the time of the kernels it launched, so only device rows
    count.  A trace that comes back with no device row at all (the
    profiler now and then drops a whole trace's device activity) is taken
    again, up to ``attempts`` times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = {}
    for attempt in range(1, attempts + 1):
        for _ in range(10):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        if rows:
            break
        log(f"profiler trace {attempt} of {attempts} held no device row")
    return rows


def device_ms_per_call(fn, n: int) -> float:
    """Device time of every kernel ``fn`` launches, per call, over ``n``
    back-to-back calls → milliseconds.  Where no trace holds a device row,
    CUDA events around calls queued behind a sleep time them instead."""
    us = sum(trace_device_us(fn, n).values())
    if us > 0:
        return us / n / 1e3
    log("no trace held a device row: timed with queued CUDA events")
    return queued_device_ms(fn, min(n, QUEUED_CALLS))


# tensor-core instructions each attention library's bf16 kernel must hold
SASS_COUNTS = {"flash_attention": "HGMMA", "decode_attention": "HMMA"}


def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump`` (on PATH, else beside ``nvcc``), or
    None where the toolkit has none."""
    from repro_torch.kernels._cuda import nvcc
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    return cand if os.path.exists(cand) else None


def sass_counts(libs) -> None:
    """Phase 2's SASS check: count the ``HGMMA`` instructions of the flash
    library and the ``HMMA`` of the decode library (``cuobjdump -sass``);
    raises if a count is 0, and prints that the check could not run where
    the toolkit has no ``cuobjdump``."""
    tool = cuobjdump()
    if tool is None:
        log("SASS check: no cuobjdump in the toolkit; HGMMA/HMMA not counted")
        return
    for lib in libs:
        op = SASS_COUNTS.get(lib.name)
        if op is None:
            continue
        sass = subprocess.run([tool, "-sass", str(lib.library_path())],
                              check=True, capture_output=True, text=True,
                              timeout=300).stdout
        n = len(re.findall(rf"\b{op}\.", sass))
        log(f"SASS check: {n} {op} instructions in lib{lib.name}.so")
        if n == 0:
            raise AssertionError(f"lib{lib.name}.so holds no {op} "
                                 f"instruction: its bf16 kernel does not "
                                 f"run on the tensor cores")


def check_tensor_core_build(lib) -> None:
    """The bf16 attention kernels (``*mma_kernel``) must build without
    spills and without a ptxas warning that it serialized their
    ``wgmma`` (C75xx)."""
    func = None
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        if "mma_kernel" not in (func or "") and "mma_kernel" not in line:
            continue
        if re.search(r"\(C75\d\d\)", line) or re.search(
                r"[1-9]\d* bytes spill (stores|loads)", line):
            raise AssertionError(f"{lib.name}: {line.strip()}")


def build_all() -> None:
    """Build every kernel library, one nvcc per source, all started
    together; print each build's time and ptxas's registers, shared memory
    and spills per kernel, then the SASS check.  Raises if a build fails,
    or if a bf16 attention kernel spills or has its wgmma serialized."""
    from repro_torch.kernels.candidate_score import kernel as CK
    from repro_torch.kernels.fused_descent import kernel as FK
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.kernels.index_lookup import kernel as IK
    libs = (FK.LIB, CK.LIB, *IK.LIBS, DK.LIB, AK.LIB)

    def timed_build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(libs)) as pool:
        futs = [pool.submit(timed_build, lib) for lib in libs]
        built = [f.result() for f in futs]      # re-raises a failed build
    for lib, (path, secs) in zip(libs, built):
        log(f"build {lib.name}: {secs:.3f} s -> {os.path.relpath(path, HERE)}")
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas: {line.split('entry function')[1].strip()}")
            elif any(w in line for w in ("registers", "smem", "spill",
                                         "C75")):
                log(f"  ptxas: {line.strip()}")
        if lib.name in SASS_COUNTS:
            check_tensor_core_build(lib)
    sass_counts(libs)


# ---------------------------------------------------------------------------
# phase 4: candidate scoring against its plain version
# ---------------------------------------------------------------------------
def score_profiles() -> dict:
    """The affine tiers phase 4 takes (ℓ, 1/B) from."""
    from repro_torch.core import (PROFILES, CachedProfile, ObjectiveProfile)
    ssd = PROFILES["azure_ssd"]
    return {"azure_ssd": ssd, "azure_nfs": PROFILES["azure_nfs"],
            "cached(azure_ssd, 0.5)": CachedProfile(backing=ssd,
                                                    hit_rate=0.5),
            "objective(azure_ssd, p0.99 w1)": ObjectiveProfile(
                base=ssd, p=P99["p"], weight=P99["weight"])}


def check_score_case(W: np.ndarray, wt: np.ndarray, ell: float,
                     inv_bw: float, device, what: str) -> float:
    """The kernel on (W, wt) against the plain version (rtol 1e-5) and the
    float64 oracle (rtol 3e-5), and a second launch bit-equal to the first
    → the largest relative error to plain."""
    import torch

    from repro_torch.kernels.candidate_score import (affine_scores,
                                                     affine_scores_ref,
                                                     affine_scores_torch)
    Wt = torch.from_numpy(np.ascontiguousarray(W, dtype=np.float32)) \
        .to(device)
    wtt = torch.from_numpy(np.ascontiguousarray(wt, dtype=np.float32)) \
        .to(device)
    got = affine_scores(Wt, wtt, ell, inv_bw)
    again = affine_scores(Wt, wtt, ell, inv_bw)
    plain = affine_scores_torch(Wt, wtt, ell, inv_bw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"candidate_score {what}: two launches on the "
                             f"same input differ")
    got = got.cpu().numpy().astype(np.float64)
    plain = plain.cpu().numpy().astype(np.float64)
    rel = float(np.max(np.abs(got - plain) / np.abs(plain)))
    oracle = affine_scores_ref(W, wt, ell, inv_bw)
    rel_ref = float(np.max(np.abs(got - oracle) / np.abs(oracle)))
    if not (rel <= SCORE_RTOL_PLAIN and rel_ref <= SCORE_RTOL_REF
            and np.all(np.isfinite(got))):
        raise AssertionError(
            f"candidate_score {what}: rel err {rel:.3e} to plain (limit "
            f"{SCORE_RTOL_PLAIN}), {rel_ref:.3e} to the float64 oracle "
            f"(limit {SCORE_RTOL_REF})")
    return rel


def check_scores(device, seed: int) -> float:
    from repro_torch.core import affine_coefficients
    rng = np.random.default_rng(seed + 2)
    coeffs = {n: affine_coefficients(p) for n, p in score_profiles().items()}
    n_cases, max_rel = 0, 0.0
    for C in (1, 7, 8, 39, 300):
        for S in (1, 127, 128, 4097, 65536, 65574, 131072):
            W = rng.uniform(16.0, 1e6, size=(C, S))
            wt = rng.uniform(0.5, 4.0, size=S)
            for name, (ell, inv_bw) in coeffs.items():
                max_rel = max(max_rel, check_score_case(
                    W, wt, ell, inv_bw, device, f"C={C} S={S} {name}"))
                n_cases += 1
    log(f"candidate_score check: {n_cases} cases, max rel err to plain "
        f"{max_rel:.3e} (limit {SCORE_RTOL_PLAIN}), all within "
        f"{SCORE_RTOL_REF} of the float64 oracle; every second launch "
        f"bit-equal to the first")
    return max_rel


def queued_numbers(fns: dict, n: int) -> tuple:
    """Device time per call of each function of ``fns`` from CUDA events
    around ``n`` calls queued behind a device sleep (no profiler trace):
    L2-cold (a 128 MiB rewrite before each call, whose own queued time is
    taken off) and back to back → ({name: cold ms}, {name: warm ms})."""
    import torch
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    rewrite = queued_device_ms(flush.neg_, n)
    cold = {k: queued_device_ms(f, n, before=flush.neg_) - rewrite
            for k, f in fns.items()}
    warm = {k: queued_device_ms(f, n) for k, f in fns.items()}
    return cold, warm


def timing(fn, rec: list):
    """``fn`` itself, called through a wrapper that appends the wall of
    each call to ``rec``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            rec.append(time.perf_counter() - t0)
    return timed


def split_summary(rec: dict) -> dict:
    """Each list's mean and median wall, in microseconds."""
    return {k: {"mean_us": float(np.mean(v)) * 1e6,
                "median_us": float(np.median(v)) * 1e6, "n": len(v)}
            for k, v in rec.items()}


def cold_device_ms(fn, n: int) -> float:
    """Device time per call of the kernels ``fn`` launches when each call
    finds the 50 MB L2 cold: a 128 MiB buffer is rewritten before each
    call → milliseconds.  ``fn``'s own device rows are named from a trace
    of back-to-back calls, and only those rows of the cold trace count,
    so the rewrite's kernels are left out; the rewrite negates the
    buffer, an operation no timed function launches (a fill would share
    its kernel's name with the plain versions' fills)."""
    import torch
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    own = set(trace_device_us(fn, n))
    rows = trace_device_us(fn, n, before=flush.neg_)
    if own and own <= set(rows) and set(rows) - own:
        return sum(rows[k] for k in own) / n / 1e3
    # a trace lost its device records: queued CUDA events, the rewrite's
    # own queued time taken off
    log("a trace lost its device rows: timed with queued CUDA events")
    m = min(n, QUEUED_CALLS)
    return (queued_device_ms(fn, m, before=flush.neg_)
            - queued_device_ms(flush.neg_, m))


def roofline_bound(nbytes: int, ops: int,
                   ops_per_s: float = F32_OPS_PER_S) -> tuple:
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def serve_phase(args, device, card, max_err: float) -> dict:
    """Phase 6 and the fused descent's numbers → its kernels-line entry."""
    import torch

    import repro_torch.serve.index_service as IS
    from repro_torch.api import ServeSpec
    from repro_torch.core import SerializedIndex, write_index
    from repro_torch.kernels.fused_descent import fused_descent_torch
    from repro_torch.kernels.fused_descent import kernel as K
    from repro_torch.kernels.fused_descent import ops as FO

    if args.draws < DRAWS:
        log(f"reduced: {args.draws} mixture draws instead of {DRAWS}")
    log(f"reduced: streams of {SERVE_BATCHES} batches instead of 256 (the "
        f"run's time limit: 128 since the training phase, 96 since the "
        f"families phase)")
    t0 = time.perf_counter()
    keys = make_keys(args.draws, args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    design = build_design(keys)
    t_build = time.perf_counter() - t0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(workdir, "index.air")
        meta = write_index(path, design, data_record=RECORD_BYTES,
                           page_bytes=4096)
        sizes = [lay.n_nodes if lay.kind == "band" else lay.n_pieces
                 for lay in design.layers]
        log(f"keys: {len(keys)} unique ({args.draws} draws) in "
            f"{t_gen:.1f} s; data extent {design.data.size_bytes} B")
        log(f"index: layer entries {sizes} (bottom-up), built in "
            f"{t_build:.1f} s; file {os.path.getsize(path)} B, bottom layer "
            f"{meta.layers[0].size} B")
        del design

        spec = ServeSpec(resident_layers=2, cache_bytes=(1 << 20, 8 << 20),
                         pipeline_depth=2)
        streams = make_streams(len(keys), args.seed, SERVE_BATCHES, BATCH)
        # the engine's own descent serves; each call of it, and of the one
        # library call inside it, is timed around the real function
        engine_descent = IS.fused_descent_with_backend
        library_call = K.fused_descent_serve
        served, reports, fused, splits = {}, {}, {}, {}
        K.reset_launches()                    # the serving path starts here
        try:
            for name, idx in streams.items():
                splits[name] = {"descent": [], "library_call": []}
                IS.fused_descent_with_backend = timing(
                    engine_descent, splits[name]["descent"])
                K.fused_descent_serve = timing(
                    library_call, splits[name]["library_call"])
                served[name], reports[name], fused[name] = serve_stream(
                    path, keys, idx, spec, None, SERVE_BATCHES)
        finally:
            IS.fused_descent_with_backend = engine_descent
            K.fused_descent_serve = library_call
        launches = K.launches()               # ... and ends here
        batches = sum(r["batches"] for r in reports.values())
        for name, r in reports.items():
            assert r["device_active"], f"{name}: resident prefix not on the card"
            assert r["device_batches"] == r["batches"], (name, r)
        assert launches >= batches, (launches, batches)
        for name, idx in streams.items():
            log(f"stream {name}: " + json.dumps(reports[name]))
            log(f"descent inside the pipelined {name} stream (wall per "
                f"call of fused_descent_with_backend and of the library "
                f"call inside it, us; two calls a batch): "
                + json.dumps(split_summary(splits[name])))

        for name, idx in streams.items():
            check_ranges(served[name], idx, name)
            ref_ranges, _, _ = serve_stream(
                path, keys, idx, spec.replace(backend="numpy"), None,
                SERVE_BATCHES)
            if not np.array_equal(served[name], ref_ranges):
                raise AssertionError(f"{name}: cuda ranges != numpy ranges")
        sample = streams["uniform"][:2000]
        sidx = SerializedIndex(path)
        try:
            want = np.asarray([sidx.lookup(int(k)) for k in keys[sample]],
                              dtype=np.int64)
        finally:
            sidx.close()
        if not np.array_equal(served["uniform"][:2000], want):
            raise AssertionError("served ranges != SerializedIndex.lookup")
        log(f"serving path: {batches} batches, {launches} fused_descent "
            f"launches; ranges contain every record, equal the numpy "
            f"backend's, and a 2000-key sample equals SerializedIndex.lookup")

        # -- the kernel at the serving shape ---------------------------------
        # the module that served the uniform stream, on every one of its
        # batches (the last is timed below)
        mod = fused["uniform"]
        L, P = mod.keys.shape
        kinds = mod.kinds.cpu().numpy()
        for b in range(SERVE_BATCHES):
            qt = torch.from_numpy(keys[streams["uniform"][
                b * BATCH:(b + 1) * BATCH]].astype(np.int32)).to(device)
            klo, khi = mod(qt)
            plo, phi = fused_descent_torch(mod.planes(), qt)
            serve_err = max(int((klo - plo).abs().max()),
                            int((khi - phi).abs().max()))
            max_err = max(max_err, float(serve_err))
            assert serve_err == 0, \
                f"serving batch {b}: kernel != plain ({serve_err})"
        # the same descent alone, on the same batches, after the launch
        # count was read
        alone = {"descent": [], "library_call": []}
        run = timing(FO.fused_descent_with_backend, alone["descent"])
        K.fused_descent_serve = timing(library_call, alone["library_call"])
        try:
            for b in range(SERVE_BATCHES):
                _, _, used = run(None, keys[streams["uniform"][
                    b * BATCH:(b + 1) * BATCH]], module=mod)
                assert used == "cuda", f"batch {b} declined by the descent"
        finally:
            K.fused_descent_serve = library_call
        log(f"descent alone on the uniform stream's batches (wall per "
            f"call, us): " + json.dumps(split_summary(alone)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # the plain version reads the layer kinds from the host, so that it
    # queues its ops without a synchronisation
    plain_planes = {**mod.planes(), "kinds": mod.kinds.cpu()}
    cold, warm = queued_numbers(
        {"ms": lambda: mod(qt),
         "plain_ms": lambda: fused_descent_torch(plain_planes, qt)}, 50)
    call_ms = time_launches(lambda: mod(qt), 200, 15)
    Q = BATCH
    n_band = int(kinds.sum())
    n_step = L - n_band
    # each input read once, each output written once: a step row needs
    # keys, pos_lo, pos_hi; a band row keys, x1, y1, m, delta
    nbytes = (4 * Q + 4 * L + 4 * L * P + 8 * P * n_step
              + 16 * P * n_band + 8 * L * Q)
    # the search's compares (ceil(log2(P+1)) per query and layer) and a
    # band row's five f32 ops, floor and ceil; the guide's table has no
    # int32 rate, so the compares are priced at the f32 peak, which can
    # only make the operations time smaller
    ops = Q * (L * math.ceil(math.log2(P + 1)) + 7 * n_band)
    bound_ms, bound_by = roofline_bound(nbytes, ops)
    log(f"fused_descent at serving shape (Q={Q}, L={L}, P={P}) on {card}: "
        f"device time per call with the L2 flushed {cold['ms'] * 1e3:.3f} "
        f"us (plain torch {cold['plain_ms'] * 1e3:.3f} us), back to back "
        f"{warm['ms'] * 1e3:.3f} us (plain torch {warm['plain_ms'] * 1e3:.3f}"
        f" us), queued CUDA events; wrapper call back to back "
        f"{call_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.4f} us by "
        f"{bound_by} ({nbytes} B, {ops} ops; {n_step} step + {n_band} band "
        f"layers); {launches} launches on the serving path")
    return {"name": "fused_descent", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches, "max_abs_err": max_err,
            "ms": cold["ms"], "plain_ms": cold["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def resident_that_packs(design) -> int:
    """How many top layers one kernel plane can hold: counted from the root
    down while a layer has at most MAX_VMEM_ENTRIES entries."""
    from repro_torch.kernels.fused_descent import MAX_VMEM_ENTRIES
    n = 0
    for lay in reversed(design.layers):
        entries = lay.n_nodes if lay.kind == "band" else lay.n_pieces
        if entries > MAX_VMEM_ENTRIES:
            break
        n += 1
    return n


def check_tuned_ranges(design, n_res: int, served: np.ndarray,
                       ref: np.ndarray) -> str:
    """Served ranges against the numpy backend's.  They must be equal,
    unless the bottom layer is a band layer held on the card: then the
    data range IS its f32 window, which the engine widens by the δ slack
    (the bound the JAX package states for its device descent), so each
    range must contain the float64 one and be at most that slack wider
    on either side."""
    from repro_torch.kernels.fused_descent import band_f32_slack
    if np.array_equal(served, ref):
        return "ranges equal the numpy backend's"
    bottom = design.layers[0]
    if n_res < design.n_layers or bottom.kind != "band":
        raise AssertionError("tuned design: cuda ranges != numpy ranges")
    # the f32 mid may sit a slack off the float64 one, and the window is
    # widened by another slack; floor/ceil add one byte each
    limit = 2.0 * float(np.max(band_f32_slack(bottom.y1, bottom.m,
                                              bottom.x1))) + 2.0
    widen = np.concatenate([ref[:, 0] - served[:, 0], served[:, 1] - ref[:, 1]])
    if widen.min() < 0 or widen.max() > limit:
        raise AssertionError(
            f"tuned design: resident band windows do not contain the numpy "
            f"ranges within the f32 slack: widening in [{widen.min()}, "
            f"{widen.max()}] B, limit {limit:.1f} B")
    n_diff = int(np.count_nonzero(np.any(served != ref, axis=1)))
    return (f"the bottom layer is a band layer held on the card, so ranges "
            f"are its f32 windows: {n_diff} of {len(ref)} differ from the "
            f"numpy backend's, each containing it and at most {widen.max()} "
            f"B wider per side (f32 slack limit {limit:.1f} B)")


def tune_phase(args, device, card, max_rel: float) -> tuple:
    """Phase 7 and the candidate-scoring numbers → its kernels-line entry
    and what phases 8-9 take over (the keys, their KeyPositions and
    generation 0, the facade's azure_ssd tune)."""
    import torch

    from repro_torch.api import Index, ServeSpec, TuneSpec
    from repro_torch.core import (PROFILES, KeyPositions,
                                  affine_coefficients, airtune, beam_search,
                                  expected_latency, objective_profile)
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels.candidate_score import (affine_scores,
                                                     affine_scores_torch)
    from repro_torch.kernels.candidate_score import kernel as CK
    from repro_torch.kernels.fused_descent import kernel as FK

    if args.tune_draws < DRAWS:
        log(f"reduced: tuning on {args.tune_draws} mixture draws instead of "
            f"{DRAWS} (a cold tune builds on the host at ~5 s per million "
            f"keys; the run's time limit forces the cut)")
    t0 = time.perf_counter()
    keys = make_keys(args.tune_draws, args.seed + 3)
    D = KeyPositions.fixed_record(keys, RECORD_BYTES)
    log(f"tuning keys: {D.n} unique ({args.tune_draws} draws) in "
        f"{time.perf_counter() - t0:.1f} s; data extent {D.size_bytes} B")
    tunes = [(name, fn, tier, None) for tier in TUNE_TIERS
             for name, fn in (("airtune", airtune), ("beam", beam_search))]
    tunes.append(("airtune", airtune, "azure_ssd", P99))

    # keep the largest device-ranked (U, S) call's inputs for the numbers
    largest = {"size": 0}
    batched_est = sweep_mod.SweepEngine._batched_est

    def recording_est(engine, W, weights):
        if engine.score_backend == "cuda" and W.size > largest["size"]:
            largest.update(size=W.size, W=W, weights=weights,
                           profile=engine.profile)
        return batched_est(engine, W, weights)

    # generation 0 of the facade loop (phase 8) is the azure_ssd airtune:
    # the run's one cold build; its retained LayerCache serves every other
    # tune of this phase
    gen0 = Index.tune(D, "azure_ssd", TuneSpec(k=5, page_bytes=4096))
    cache = None
    results = {}
    est_batches = 0
    sweep_mod.SweepEngine._batched_est = recording_est
    try:
        CK.reset_launches()                   # the tuning path starts here
        FK.reset_launches()
        for name, fn, tier, objective in tunes:
            key = f"{name}/{tier}" + ("/p99" if objective else "")
            pair = {}
            for backend in ("cuda", "numpy"):
                t0 = time.perf_counter()
                if key == "airtune/azure_ssd" and backend == "cuda":
                    res = gen0.build().result
                    cache = gen0.layer_cache
                else:
                    res = fn(D, PROFILES[tier], k=5, layer_cache=cache,
                             objective=objective, score_backend=backend)
                wall = time.perf_counter() - t0
                st = res.stats
                pair[backend] = res
                log(f"tune {key} [{backend}]: wall {wall:.3f} s, sweep "
                    f"{st.sweep_seconds:.3f} s, cost {res.cost!r}, "
                    f"{list(res.builder_names)}; stats "
                    + json.dumps(dataclasses.asdict(st)))
            cu, nu = pair["cuda"], pair["numpy"]
            est_batches += cu.stats.est_batches
            if not abs(cu.cost - nu.cost) <= 1e-6 * abs(nu.cost):
                raise AssertionError(f"{key}: cuda cost {cu.cost!r} != numpy "
                                     f"cost {nu.cost!r} (rel 1e-6)")
            log(f"tune {key}: cuda and numpy costs agree (rel "
                f"{abs(cu.cost - nu.cost) / nu.cost:.3e}); designs "
                f"{'equal' if cu.builder_names == nu.builder_names else 'DIFFER'}")
            results[key] = cu
        best = results["airtune/azure_ssd"]
        assert best is gen0.result, "generation 0 is the azure_ssd airtune"
        exact = expected_latency(best.design, PROFILES["azure_ssd"])
        assert abs(exact - best.cost) <= 1e-9 * best.cost, (exact, best.cost)
        p99 = results["airtune/azure_ssd/p99"]
        exact = expected_latency(p99.design, objective_profile(
            PROFILES["azure_ssd"], P99))
        assert abs(exact - p99.cost) <= 1e-9 * p99.cost, (exact, p99.cost)

        workdir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
        try:
            path = os.path.join(workdir, "tuned.air")
            gen0.save(path, data_record=RECORD_BYTES)
            n_res = resident_that_packs(best.design)
            spec = ServeSpec(resident_layers=n_res)
            idx = make_streams(D.n, args.seed + 3, TUNE_BATCHES,
                               BATCH)["uniform"]
            served, report, _ = serve_stream(path, keys, idx, spec, None,
                                             TUNE_BATCHES)
            cs_launches = CK.launches()       # ... and ends here
            fd_launches = FK.launches()
            check_ranges(served, idx, "tuned design")
            ref_ranges, _, _ = serve_stream(
                path, keys, idx, spec.replace(backend="numpy"), None,
                TUNE_BATCHES)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    finally:
        sweep_mod.SweepEngine._batched_est = batched_est
    ranges_note = check_tuned_ranges(best.design, n_res, served, ref_ranges)
    assert report["device_batches"] == report["batches"] == TUNE_BATCHES, \
        report
    assert cs_launches >= est_batches >= 1, (cs_launches, est_batches)
    assert fd_launches >= TUNE_BATCHES, fd_launches
    log(f"tuned design {best.design.describe()}: {n_res} of "
        f"{best.design.n_layers} layers resident; " + json.dumps(report))
    log(f"tuning path: {len(tunes)} cuda tunes made {est_batches} device "
        f"rankings with {cs_launches} candidate_score launches; the tuned "
        f"design served {TUNE_BATCHES} batches with {fd_launches} "
        f"fused_descent launches; ranges contain every record; {ranges_note}")

    # -- the kernel at the largest shape the tunes launched ------------------
    W, wt, prof = largest["W"], largest["weights"], largest["profile"]
    ell, inv_bw = affine_coefficients(prof)
    U, S = W.shape
    max_rel = max(max_rel, check_score_case(W, wt, ell, inv_bw, device,
                                            f"tuning shape U={U} S={S}"))
    Wt = torch.from_numpy(np.ascontiguousarray(W, dtype=np.float32)).to(device)
    wtt = torch.from_numpy(np.ascontiguousarray(wt, dtype=np.float32)) \
        .to(device)
    den = wtt.sum()
    base = torch.full((U,), ell, dtype=torch.float32, device=device) * den

    def kern():
        return affine_scores(Wt, wtt, ell, inv_bw)

    def plain():
        return affine_scores_torch(Wt, wtt, ell, inv_bw)

    def library():
        # the yardstick: one BLAS call (ℓ·Σw + inv_bw·W·w) and one division
        # compute the same function; timed here, never used by the port
        return torch.addmv(base, Wt, wtt, alpha=inv_bw).div_(den)

    # the tuner copies W to the card just before each launch, but 10.5 MB
    # of widths sit in the 50 MB L2 only while nothing else ran since; the
    # kernels line holds the L2-cold times against the device-memory bound
    # (queued CUDA events: a CUPTI trace now and then loses device rows)
    cold, warm = queued_numbers({"ms": kern, "plain_ms": plain,
                                 "library_ms": library}, QUEUED_CALLS)
    call_ms = time_launches(kern, 200, 15)
    from repro_torch.kernels.candidate_score.kernel import split_count
    n_split = split_count(U, S, torch.cuda.get_device_properties(
        0).multi_processor_count)
    nbytes = 4 * U * S + 4 * S + 4 * U
    bound_ms, bound_by = roofline_bound(nbytes, 3 * U * S)
    log(f"candidate_score at the largest tuning shape (U={U}, S={S}, "
        f"{prof.name}; {n_split} blocks a row) on {card}: device time per "
        f"call with the L2 flushed {cold['ms'] * 1e3:.3f} us (plain torch "
        f"{cold['plain_ms'] * 1e3:.3f} us; torch.addmv + div "
        f"{cold['library_ms'] * 1e3:.3f} us, two calls), back to back "
        f"(L2-warm) {warm['ms'] * 1e3:.3f} us (plain torch "
        f"{warm['plain_ms'] * 1e3:.3f} us; torch.addmv + div "
        f"{warm['library_ms'] * 1e3:.3f} us), queued CUDA events; wrapper "
        f"call back to back {call_ms * 1e3:.3f} us; bound "
        f"{bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} B, {3 * U * S} "
        f"ops); {cs_launches} launches on the tuning path")
    return {"name": "candidate_score", "route": "cuda",
            "source": SCORE_SOURCE, "replaces": SCORE_REPLACES,
            "launches": cs_launches, "max_abs_err": max_rel,
            "ms": cold["ms"], "plain_ms": cold["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cold["library_ms"]}, {"keys": keys, "D": D,
                                                "gen0": gen0}


# ---------------------------------------------------------------------------
# phase 5: the index-lookup kernels against their plain versions
# ---------------------------------------------------------------------------
def lookup_layer(rng, P: int, band: bool) -> tuple:
    """A random int32 layer of P entries whose first key is 1, so every
    query in [1, 2^31-2) lies in its domain: step → (keys, pos) with P + 1
    positions, band → (keys, x1, y1, m, delta).  Up to ~2 M entries the
    keys are distinct multiples of 997 (plus 2); a wider layer's keys are 1
    plus a running sum of gaps U[1, 2^31 / P)."""
    step = 997
    if P <= (2**31 - 5) // step:
        keys = np.concatenate([[1], np.sort(rng.choice(
            (2**31 - 5) // step, P - 1, replace=False)) * step + 2])
    else:
        keys = 1 + np.concatenate([[0], np.cumsum(rng.integers(
            1, (2**31 - 2) // P, P - 1))])
    keys = keys.astype(np.int32)
    if band:
        return (keys, keys.astype(np.float32),
                np.sort(rng.uniform(0, 2**24, P)).astype(np.float32),
                rng.uniform(0.0, 0.01, P).astype(np.float32),
                rng.uniform(1.0, 600.0, P).astype(np.float32))
    return keys, np.sort(rng.integers(0, 2**30, P + 1)).astype(np.int32)


def check_lookup_kernels(device, seed: int) -> dict:
    """Every tested shape: each index-lookup kernel equals its plain
    version on the card bit for bit, and step and segmented rows equal the
    float64 ``layer.predict``.  Returns name → max |kernel − plain| (0
    when the check passes)."""
    import torch

    from repro_torch.core import StepLayer
    from repro_torch.kernels import index_lookup as il
    from repro_torch.kernels.index_lookup import kernel as IK
    rng = np.random.default_rng(seed + 5)
    errs = dict.fromkeys(LOOKUP_KERNELS, 0.0)
    n_cases = 0
    # the widths whose grid (one key in LANE) just fits and just overflows
    # the shared memory a block may hold: the second searches its grid in
    # global memory
    cap = IK.grid_cap() * il.LANE
    seg_p = LOOKUP_SEG_P + (cap, cap + 1)

    def on(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    def queries(Q: int, keys: np.ndarray) -> np.ndarray:
        q = rng.integers(0, 2**31 - 2, Q).astype(np.int32)
        k = min(Q, 4)
        q[:k] = keys[rng.integers(0, len(keys), k)]     # equal to keys
        if Q > 8:
            q[k:k + 4] = (0, keys[-1], keys[-1] + 1, 2**31 - 1)
        grid = keys[::il.LANE]
        if Q >= 16 + len(grid):                          # every grid key
            q[16:16 + len(grid)] = grid
        return q

    def held(name, got, want, what):
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        errs[name] = max(errs[name], float(err))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} != plain at {what}: max |diff| "
                                 f"{err}")

    for P in LOOKUP_STEP_P + seg_p:
        keys, pos = lookup_layer(rng, P, band=False)
        layer = StepLayer(piece_keys=keys.astype(np.uint64),
                          piece_pos=pos.astype(np.int64),
                          node_piece_off=np.arange(P + 1, dtype=np.int64))
        kt, plo, phi = on(keys, pos[:-1], pos[1:])
        seg = P > il.MAX_VMEM_ENTRIES
        name = "segmented_step_lookup" if seg else "step_lookup"
        for Q in LOOKUP_Q:
            q = queries(Q, keys)
            qt, = on(q)
            if seg:
                got = IK.segmented_step_lookup_cuda(qt, kt, plo, phi)
                want = il.segmented_step_lookup_torch(
                    qt, il.segment_bases(kt, qt), kt, plo, phi)
            else:
                got = IK.step_lookup_cuda(qt, kt, plo, phi)
                want = il.step_lookup_torch(qt, kt, plo, phi)
            held(name, got, want, f"P={P} Q={Q}")
            rlo, rhi = layer.predict(q.astype(np.uint64))
            if not (np.array_equal(got[0].cpu().numpy(), rlo)
                    and np.array_equal(got[1].cpu().numpy(), rhi)):
                raise AssertionError(f"{name} != float64 layer.predict at "
                                     f"P={P} Q={Q}")
            n_cases += 1
    for P in LOOKUP_BAND_P:
        arrays = lookup_layer(rng, P, band=True)
        ts = on(*arrays)
        for Q in LOOKUP_Q:
            qt, = on(queries(Q, arrays[0]))
            held("band_lookup", IK.band_lookup_cuda(qt, *ts),
                 il.band_lookup_torch(qt, *ts), f"P={P} Q={Q}")
            n_cases += 1
    log(f"index-lookup kernel check: {n_cases} shapes (segmented P = "
        f"{cap} and {cap + 1} at the block's grid cap of {cap // il.LANE} "
        f"entries too), each kernel == its plain "
        f"version bit for bit, step and segmented rows == the float64 "
        f"layer.predict")
    return errs


# ---------------------------------------------------------------------------
# phase 8: the facade's observe → drift → warm retune → swap loop
# ---------------------------------------------------------------------------
def designs_equal(a, b) -> bool:
    if len(a.layers) != len(b.layers):
        return False
    for la, lb in zip(a.layers, b.layers):
        if la.kind != lb.kind:
            return False
        fields = (("piece_keys", "piece_pos", "node_piece_off")
                  if la.kind == "step"
                  else ("node_keys", "x1", "y1", "m", "delta"))
        if not all(np.array_equal(getattr(la, f), getattr(lb, f))
                   for f in fields):
            return False
    return True


def loop_phase(args, tuned: dict):
    """Phase 8: generation 0 saved, served on azure_hdd with persisted
    stats, observed; a warm retune for the observed profile (checked
    against its numpy-ranked twin) saved as generation 1 and swapped in
    under a pipelined stream in a second thread → generation 1's Index."""
    import threading

    from repro_torch.api import Index, detect_drift_from_file
    from repro_torch.core import affine_coefficients
    keys, D, gen0 = tuned["keys"], tuned["D"], tuned["gen0"]
    idx = make_streams(D.n, args.seed + 5, LOOP_BATCHES, BATCH)["uniform"]
    batches = np.split(keys[idx], LOOP_BATCHES)
    deployed = dict(profile="azure_hdd", resident_layers=0)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        paths = [os.path.join(workdir, f"gen{g}.air") for g in (0, 1)]
        gen0.save(paths[0], data_record=RECORD_BYTES)
        opened = Index.open(paths[0], data=D)
        t0 = time.perf_counter()
        svc = opened.serve(persist_stats=True, **deployed)
        try:
            truth0 = svc.lookup_batches(batches)
            report = opened.observe(svc)
            served = dataclasses.replace(svc.stats)
        finally:
            svc.close()
        t_serve = time.perf_counter() - t0
        check_ranges(np.concatenate(truth0), idx, "generation 0 on azure_hdd")
        assert served.device_batches == served.batches == LOOP_BATCHES, \
            served
        log(f"loop: generation 0 ({gen0.design.describe()}) served "
            f"{LOOP_BATCHES} batches on azure_hdd in {t_serve:.3f} s; "
            f"{report.describe()}")
        if report.action != "retune":
            raise AssertionError(f"generation 0 on azure_hdd: the drift "
                                 f"report says {report.action!r}, not "
                                 f"'retune'")
        offline = detect_drift_from_file(paths[0])
        if offline is None or offline.action != report.action:
            raise AssertionError(f"detect_drift_from_file disagrees: "
                                 f"{offline and offline.describe()}")
        prof = report.observed_profile
        folds = affine_coefficients(prof) is not None
        t0 = time.perf_counter()
        gen1 = gen0.retune(prof, warm_start=True).build()
        t_retune = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = gen0.retune(prof, warm_start=True,
                           score_backend="numpy").build()
        t_twin = time.perf_counter() - t0
        r1, rt = gen1.result, twin.result
        if (r1.builder_names != rt.builder_names
                or not designs_equal(r1.design, rt.design)
                or not abs(r1.cost - rt.cost) <= 1e-6 * abs(rt.cost)):
            raise AssertionError(f"warm retune: cuda {r1.builder_names} "
                                 f"{r1.cost!r} != numpy {rt.builder_names} "
                                 f"{rt.cost!r}")
        if not r1.stats.layers_reused > 0:
            raise AssertionError(f"warm retune reused no layer: {r1.stats}")
        log(f"loop: observed profile {prof!r} "
            f"{'folds to affine coefficients and ranks on the card' if folds else 'does not fold to affine coefficients, so the retune ranks on exact numpy by design'}; "
            f"warm retune {t_retune:.3f} s (numpy twin {t_twin:.3f} s), "
            f"{list(r1.builder_names)} cost {r1.cost!r} (twin {rt.cost!r}, "
            f"same design); stats " + json.dumps(dataclasses.asdict(r1.stats)))
        gen1.save(paths[1], data_record=RECORD_BYTES)
        with Index.open(paths[1], data=D).serve(**deployed) as svc1:
            truth1 = svc1.lookup_batches(batches)
        check_ranges(np.concatenate(truth1), idx, "generation 1")

        svc = opened.serve(pipeline_depth=2, **deployed)
        out = {}
        worker = threading.Thread(
            target=lambda: out.update(r=svc.lookup_batches(batches)),
            daemon=True)
        try:
            worker.start()
            while svc.stats.batches < LOOP_BATCHES // 4 and worker.is_alive():
                time.sleep(0.0005)
            old_stats = svc.stats
            t0 = time.perf_counter()
            svc.swap(paths[1])
            t_swap = time.perf_counter() - t0
            worker.join(timeout=600)
            if worker.is_alive():
                raise AssertionError("the serving thread did not finish "
                                     "within 600 s of the swap")
            swaps = svc.stats.swaps
            per_epoch = (old_stats.batches, svc.stats.batches)
        finally:
            svc.close()
        if "r" not in out:
            raise AssertionError("the serving thread failed during the swap")
        n_from = [0, 0, 0]          # generation 0 only, 1 only, either
        for i, got in enumerate(out["r"]):
            eq = [np.array_equal(got, t[i]) for t in (truth0, truth1)]
            if not any(eq):
                raise AssertionError(f"swap: batch {i} equals neither "
                                     f"generation's ranges")
            n_from[2 if all(eq) else eq.index(True)] += 1
        if swaps != 1 or sum(per_epoch) != LOOP_BATCHES:
            raise AssertionError(f"stats.swaps == {swaps} (want 1); batches "
                                 f"per epoch {per_epoch}")
        differ = sum(not np.array_equal(a, b) for a, b in zip(truth0, truth1))
        log(f"loop: swap took {t_swap:.6f} s under a pipelined stream; "
            f"{per_epoch[0]} batches served on generation 0's epoch, "
            f"{per_epoch[1]} on generation 1's; the generations' ranges "
            f"differ on {differ} of {LOOP_BATCHES} batches; of "
            f"{LOOP_BATCHES} batches {n_from[0]} match generation 0 only, "
            f"{n_from[1]} generation 1 only, {n_from[2]} both; no batch "
            f"mixes generations; stats.swaps == 1; detect_drift_from_file "
            f"agrees ({offline.action})")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return gen1


# ---------------------------------------------------------------------------
# phase 9: the in-memory Alg. 1 on the card
# ---------------------------------------------------------------------------
def traverse_stream(name: str, layers: list, design, keys: np.ndarray,
                    idx: np.ndarray, big: np.ndarray, device) -> dict:
    """One design through ``traverse_index`` on a uniform stream and one
    2^20-key batch; every range must contain its record; a step bottom
    must equal the float64 ``lookup_batch``, a band bottom is compared
    with it (count and size of the differences).  The host split of a
    batch: the int32 cast, the copy in, each layer's call (the port's own
    ``lookup_step_layer`` / ``lookup_band_layer``, timed by wrappers
    around them), the rest of ``traverse_index``, the stack of lo and hi,
    the copy out (which waits for the card) and the int64 widening."""
    import torch

    from repro_torch.core import lookup_batch
    from repro_torch.kernels.index_lookup import ops

    calls = []                  # each layer call's wall, top-down a batch
    split = {k: [] for k in ("cast", "h2d", "traverse", "stack", "d2h",
                             "widen")}

    def run(ix):
        pc = time.perf_counter
        t = [pc()]
        q = keys[ix].astype(np.int32)
        t.append(pc())
        qt = torch.from_numpy(q).to(device)
        t.append(pc())
        lo, hi = ops.traverse_index(layers, qt)
        t.append(pc())
        st = torch.stack([lo, hi], 1)
        t.append(pc())
        c = st.cpu()
        t.append(pc())
        out = c.numpy().astype(np.int64)
        t.append(pc())
        for i, k in enumerate(split):
            split[k].append(t[i + 1] - t[i])
        return out

    n = design.n_layers
    names = []                  # top-down, as traverse_index calls them
    for i, layer in enumerate(design.layers):
        w = len(layer.piece_keys if layer.kind == "step" else layer.node_keys)
        names.insert(0, f"L{i + 1} {layer.kind} P={w}")
    step_fn, band_fn = ops.lookup_step_layer, ops.lookup_band_layer
    ops.lookup_step_layer = timing(step_fn, calls)
    ops.lookup_band_layer = timing(band_fn, calls)
    try:
        torch.cuda.synchronize()
        walls, out = [], []
        t_all = time.perf_counter()
        for b in range(N_BATCHES):
            t0 = time.perf_counter()
            out.append(run(idx[b * BATCH:(b + 1) * BATCH]))
            walls.append(time.perf_counter() - t0)
        stream_wall = time.perf_counter() - t_all
        t0 = time.perf_counter()
        rbig = run(big)
        big_wall = time.perf_counter() - t0
    finally:
        ops.lookup_step_layer, ops.lookup_band_layer = step_fn, band_fn
    walls = np.asarray(walls)

    def host_split(rows: slice) -> dict:
        us = {k: float(np.median(v[rows])) * 1e6 for k, v in split.items()}
        per = np.asarray(calls).reshape(-1, n)[rows]
        for j, nm in enumerate(names):
            us[f"call {nm}"] = float(np.median(per[:, j])) * 1e6
        us["traverse rest"] = us["traverse"] - sum(
            us[f"call {nm}"] for nm in names)
        return us

    rep = {"layers": n, "bottom": design.layers[0].kind,
           "lookups_per_s": len(idx) / stream_wall,
           "batch_wall_mean_s": float(walls.mean()),
           "batch_wall_median_s": float(np.median(walls)),
           "batch_wall_p99_s": float(np.quantile(walls, 0.99)),
           "big_batch_wall_s": big_wall,
           "big_batch_lookups_per_s": len(big) / big_wall,
           "host_split_median_us": host_split(slice(0, N_BATCHES)),
           "host_split_2^20_batch_us": host_split(slice(N_BATCHES, None))}
    for ranges, ix, what in ((np.concatenate(out), idx, "stream"),
                             (rbig, big, "2^20 batch")):
        check_ranges(ranges, ix, f"{name} {what}")
        mem = lookup_batch(design, keys[ix])
        ref = np.stack([mem.lo, mem.hi], 1).astype(np.int64)
        if rep["bottom"] == "step":
            if not np.array_equal(ranges, ref):
                raise AssertionError(f"{name} {what}: step-bottom ranges != "
                                     f"the float64 lookup_batch")
            rep[f"{what} vs lookup_batch"] = "equal"
        else:
            d = np.abs(ranges - ref)
            rep[f"{what} vs lookup_batch"] = {
                "rows_differing": int(np.count_nonzero(d.any(axis=1))),
                "rows": len(ix), "max_abs_diff_lo": int(d[:, 0].max()),
                "max_abs_diff_hi": int(d[:, 1].max())}
    return rep


def lookup_numbers(kern, plain, library, nbytes: int, ops: int) -> dict:
    """One index-lookup kernel's device times at one shape: L2-cold (a
    128 MiB rewrite before each call) and back to back, beside its plain
    version, the library call where there is one and its bound; and the
    wrapper call's wall back to back (CUDA events around 200 calls)."""
    bound_ms, bound_by = roofline_bound(nbytes, ops)
    return {"ms": cold_device_ms(kern, 50),
            "plain_ms": cold_device_ms(plain, 50),
            "library_ms": cold_device_ms(library, 50) if library else None,
            "warm_ms": device_ms_per_call(kern, 200),
            "plain_warm_ms": device_ms_per_call(plain, 200),
            "library_warm_ms": device_ms_per_call(library, 200) if library
            else None,
            "wrapper_ms": time_launches(kern, 200, 15),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


def log_lookup_numbers(name: str, shape: str, card: str, r: dict,
                       launches: int | None = None) -> None:
    def us(v):
        return "n/a" if v is None else f"{v * 1e3:.3f} us"

    log(f"{name} at {shape} on {card}: device time per call with the L2 "
        f"flushed {us(r['ms'])} (plain torch {us(r['plain_ms'])}; "
        f"torch.searchsorted + gather {us(r['library_ms'])}), back to back "
        f"{us(r['warm_ms'])} (plain {us(r['plain_warm_ms'])}; yardstick "
        f"{us(r['library_warm_ms'])}); wrapper call back to back "
        f"{us(r['wrapper_ms'])}; bound {r['bound_ms'] * 1e3:.4f} us by "
        f"{r['bound_by']} ({r['bytes']} B, {r['ops']} ops)"
        + ("" if launches is None else
           f"; {launches} launches on the in-memory Alg. 1 path"))


def lookup_kernel_entry(name: str, launches: int, err: float,
                        at: dict) -> dict:
    """The kernels-line entry of one index-lookup kernel from its numbers
    at the stream's batch (``at[BATCH]``), with the 2^20-key batch's under
    ``at_2^20`` and any other shape's under ``at_<shape>`` where they were
    measured."""
    r = at[BATCH]
    source, replaces = LOOKUP_KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]}
    for shape, r in at.items():
        if shape != BATCH:
            entry["at_2^20" if shape == LOOKUP_BIG_Q else f"at_{shape}"] = {
                k: r[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "wrapper_ms")}
    return entry


def segmented_bytes(keys: np.ndarray, q: np.ndarray) -> int:
    """The bytes the two-level lookup of the batch ``q`` must move: its
    queries and windows (12 B a query), 4 B of key for each entry of a
    segment a query falls in, 8 B of positions for each distinct entry
    chosen."""
    from repro_torch.kernels.index_lookup import LANE
    P = len(keys)
    g = np.maximum(np.searchsorted(keys[::LANE], q, side="right") - 1, 0)
    bases = np.unique(g).astype(np.int64) * LANE
    seg_keys = int(np.minimum(LANE, P - bases).sum())
    picked = np.unique(np.maximum(np.searchsorted(keys, q, side="right") - 1,
                                  0)).size
    return 12 * len(q) + 4 * seg_keys + 8 * picked


def alg1_phase(args, device, card, tuned: dict, gen1, errs: dict) -> list:
    """Phase 9: ``traverse_index`` on the card over the tuning phase's keys
    for both loop generations and a gstep(8, 4096) <- gband(1024) <-
    gstep(8, 4096) design, then each lookup kernel's numbers at that
    design's shapes (band and segmented at the stream's batch and at 2^20
    keys; the band also at generation 0's width) → the three kernels-line
    entries."""
    import torch

    from repro_torch.kernels import index_lookup as il
    from repro_torch.kernels.index_lookup import kernel as IK
    keys, D = tuned["keys"], tuned["D"]
    t0 = time.perf_counter()
    manual = build_design(keys)
    t_build = time.perf_counter() - t0
    designs = {"generation 0": tuned["gen0"].design,
               "generation 1": gen1.design, "gstep<-gband<-gstep": manual}
    idx = make_streams(D.n, args.seed + 6, N_BATCHES, BATCH)["uniform"]
    big = np.random.default_rng(args.seed + 7).integers(0, D.n,
                                                         LOOKUP_BIG_Q)
    planes = {name: il.device_arrays_from_design(d)
              for name, d in designs.items()}
    for lib in IK.LIBS:
        lib.reset_launches()                 # the in-memory path starts here
    reports = {name: traverse_stream(name, planes[name], d, keys, idx, big,
                                     device)
               for name, d in designs.items()}
    launches = {lib.name: lib.launches() for lib in IK.LIBS}  # ... ends here
    want = sum(d.n_layers for d in designs.values()) * (N_BATCHES + 1)
    for name, d in designs.items():
        log(f"in-memory Alg. 1, {name} ({d.describe()}): "
            + json.dumps(reports[name]))
    if not (all(n > 0 for n in launches.values())
            and sum(launches.values()) == want):
        raise AssertionError(f"in-memory Alg. 1 launches {launches}, "
                             f"expected {want} in all, each kernel > 0")
    log(f"in-memory Alg. 1 path: {len(designs)} designs x ({N_BATCHES} "
        f"batches + one 2^20 batch), launches {launches}; every range "
        f"contains its record; step bottoms equal lookup_batch; manual "
        f"design built in {t_build:.1f} s")

    # -- each kernel at the manual design's shapes ---------------------------
    ml = planes["gstep<-gband<-gstep"]
    bottom, band, top = ml[0], ml[1], ml[2]
    Pb, Pm, Pt = (int(x.shape[0]) for x in (bottom["piece_keys"],
                                            band["node_keys"],
                                            top["piece_keys"]))
    assert Pb > il.MAX_VMEM_ENTRIES >= max(Pm, Pt), (Pb, Pm, Pt)
    qs = {BATCH: keys[idx[-BATCH:]].astype(np.int32),
          LOOKUP_BIG_Q: keys[big].astype(np.int32)}
    qts = {Q: torch.from_numpy(q).to(device) for Q, q in qs.items()}

    def held(got, want_, what):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want_)):
            raise AssertionError(f"{what}: kernel != plain on phase 9's batch")

    def step_parts(layer):
        k = layer["piece_keys"]
        pos = layer["piece_pos"]
        plo, phi = pos[:-1], pos[1:]
        # the yardstick's gather table: entry r of searchsorted-right is
        # piece max(r − 1, 0)
        pos2 = torch.stack([plo, phi], 1)
        table = torch.cat([pos2[:1], pos2]).contiguous()
        return k, plo, phi, table

    entries = []
    # the step kernel at the path's top layer and at a layer of phase 5's
    # widest single-call width, both batch sizes
    wide_keys, wide_pos = lookup_layer(np.random.default_rng(args.seed + 8),
                                       LOOKUP_WIDE_STEP_P, band=False)
    wide = {"piece_keys": torch.from_numpy(wide_keys).to(device),
            "piece_pos": torch.from_numpy(wide_pos).to(device)}
    at = {}
    for what, layer in (("the top layer", top), ("a 4096-wide layer", wide)):
        k, plo, phi, table = step_parts(layer)
        P = len(k)
        for Q, qt in qts.items():
            held(IK.step_lookup_cuda(qt, k, plo, phi),
                 il.step_lookup_torch(qt, k, plo, phi),
                 f"step_lookup at Q={Q}, P={P}")
            r = lookup_numbers(
                lambda qt=qt, k=k, plo=plo, phi=phi: IK.step_lookup_cuda(
                    qt, k, plo, phi),
                lambda qt=qt, k=k, plo=plo, phi=phi: il.step_lookup_torch(
                    qt, k, plo, phi),
                lambda qt=qt, k=k, table=table: table[torch.searchsorted(
                    k, qt, right=True)],
                # queries, keys, lo and hi, and the P + 1 words of
                # piece_pos that pos_lo and pos_hi are two views of
                12 * Q + 4 * P + 4 * (P + 1),
                Q * math.ceil(math.log2(P + 1)))
            top_layer = layer is top
            log_lookup_numbers("step_lookup", f"{what} (Q={Q}, P={P})", card,
                               r, launches["step_lookup"] if top_layer
                               else None)
            at[Q if top_layer else f"P={P} Q={Q}"] = r
    entries.append(lookup_kernel_entry("step_lookup",
                                       launches["step_lookup"],
                                       errs["step_lookup"], at))

    # the band: the manual design's layer, and generation 0's where its
    # bottom is a band layer
    bands = {"the band layer": band}
    g0 = planes["generation 0"][0]
    if g0["kind"] == "band":
        bands["generation 0's band layer"] = g0
    at = {}
    for i, (what, layer) in enumerate(bands.items()):
        bt = [layer[f] for f in ("node_keys", "x1", "y1", "m", "delta")]
        P = len(bt[0])
        for Q, qt in qts.items():
            held(IK.band_lookup_cuda(qt, *bt), il.band_lookup_torch(qt, *bt),
                 f"band_lookup at Q={Q}, P={P}")
            r = lookup_numbers(
                lambda qt=qt, bt=bt: IK.band_lookup_cuda(qt, *bt),
                lambda qt=qt, bt=bt: il.band_lookup_torch(qt, *bt), None,
                12 * Q + 20 * P, Q * (math.ceil(math.log2(P + 1)) + 7))
            log_lookup_numbers("band_lookup", f"{what} (Q={Q}, P={P})", card, r,
                               launches["band_lookup"] if i == 0 else None)
            if i == 0:
                at[Q] = r
    entries.append(lookup_kernel_entry("band_lookup", launches["band_lookup"],
                                       errs["band_lookup"], at))

    # the two-level layer: one launch a call, no PyTorch op before it
    k, plo, phi, table = step_parts(bottom)
    kn = k.cpu().numpy()
    lay = (k, bottom["piece_pos"])
    n0 = IK.SEGMENTED.launches()
    for _ in range(20):
        il.lookup_step_layer(qts[BATCH], *lay)
    torch.cuda.synchronize()
    counted = IK.SEGMENTED.launches() - n0
    rows = trace_device_us(lambda: il.lookup_step_layer(qts[BATCH], *lay), 20)
    if counted != 20 or (rows and not all(
            "segmented_step_lookup_kernel" in nm for nm in rows)):
        raise AssertionError(f"20 two-level layer calls: {counted} segmented "
                             f"launches, device rows {sorted(rows)}")
    log(f"the two-level layer call (P={Pb}, Q={BATCH}) on the card: 20 calls, "
        f"{counted} segmented launches; device rows of a traced call: "
        + (", ".join(sorted(rows)) if rows else "none held by the trace"))
    at = {}
    for Q, qt in qts.items():
        held(IK.segmented_step_lookup_cuda(qt, k, plo, phi),
             il.segmented_step_lookup_torch(qt, il.segment_bases(k, qt), k,
                                            plo, phi),
             f"segmented_step_lookup at Q={Q}")
        at[Q] = lookup_numbers(
            lambda qt=qt: IK.segmented_step_lookup_cuda(qt, k, plo, phi),
            lambda qt=qt: il.segmented_step_lookup_torch(
                qt, il.segment_bases(k, qt), k, plo, phi),
            lambda qt=qt: table[torch.searchsorted(k, qt, right=True)],
            segmented_bytes(kn, qs[Q]), Q * math.ceil(math.log2(Pb + 1)))
        g = np.maximum(np.searchsorted(kn[::il.LANE], qs[Q], side="right")
                       - 1, 0)
        log_lookup_numbers(
            "segmented_step_lookup", f"the bottom layer (Q={Q}, P={Pb}, "
            f"{np.unique(g).size} segments touched)", card, at[Q],
            launches["segmented_step_lookup"])
    entries.append(lookup_kernel_entry(
        "segmented_step_lookup", launches["segmented_step_lookup"],
        errs["segmented_step_lookup"], at))
    return entries


# ---------------------------------------------------------------------------
# phase 13: the sharded fleet on the card
# ---------------------------------------------------------------------------
def dies_after_open_factory(sick_path: str):
    """A ``path -> StorageBackend`` factory whose backend for
    ``sick_path`` is healthy while its service opens and raises EIO on
    every read once ``armed["on"]`` is set → (factory, armed)."""
    import errno

    from repro_torch.serve import FileBackend
    armed = {"on": False}

    class DiesAfterOpen(FileBackend):
        def pread(self, nbytes, offset):
            if armed["on"]:
                raise OSError(errno.EIO, "injected post-open EIO")
            return super().pread(nbytes, offset)

    def make(path):
        return DiesAfterOpen(path) if path == sick_path else FileBackend(path)
    return make, armed


def fleet_phase(args, device, card, tuned: dict) -> int:
    """Phase 13: the tuning phase's keys as a fleet of FLEET_SHARDS
    key-range shards, each tuned on the card (``Fleet.tune(...).build()``),
    saved with a global cache budget below the shards' cacheable working
    sets together, reopened and served on the card over a uniform and a
    Zipf(1.1) stream; checked against a numpy-backend ``FleetService``,
    ``Fleet.lookup`` and a shard that dies after open → the
    ``fused_descent`` launches of the served streams."""
    import torch

    from repro_torch.api import ServeSpec, TuneSpec
    from repro_torch.core import PROFILES, KeyPositions
    from repro_torch.fleet import Fleet, FleetSpec, ShardUnavailableError
    from repro_torch.kernels.fused_descent import kernel as FK
    from repro_torch.kernels.fused_descent import ref as FR
    from repro_torch.serve import cacheable_working_set

    keys = tuned["keys"]
    D = KeyPositions.fixed_record(keys, FLEET_RECORD)
    log(f"fleet: the tuning phase's {D.n} keys with {FLEET_RECORD}-byte "
        f"records")
    spec = FleetSpec(n_shards=FLEET_SHARDS,
                     tune=TuneSpec(k=FLEET_K, page_bytes=4096),
                     serve=ServeSpec(persist_stats=True))
    res = spec.serve.resident_layers
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        t0 = time.perf_counter()
        built = Fleet.tune(D, "azure_ssd", spec).build()
        t_tune = time.perf_counter() - t0
        # the global budget: half the shards' cacheable working sets
        # together, in whole pages, so the allocator has to choose
        sets = [d.working_set for d in built.allocate_cache(1 << 62).demands]
        budget = max(sum(sets) // 2 // spec.quantum, 1) * spec.quantum
        fleet = Fleet(spec=spec.replace(cache_budget_bytes=budget),
                      shard_map=built.shard_map, shards=built.shards,
                      bases=built.bases, profile=PROFILES["azure_ssd"],
                      profile_name="azure_ssd")
        t0 = time.perf_counter()
        fleet.save(workdir)
        t_save = time.perf_counter() - t0
        log(f"fleet: {FLEET_SHARDS} shards of {D.n} keys tuned on the card "
            f"in {t_tune:.1f} s, saved in {t_save:.1f} s; designs "
            + "; ".join(f"shard {i}: {x.design.describe()} "
                        f"({x.design.data.n} keys, cost {x.cost!r})"
                        for i, x in enumerate(fleet.shards)))
        opened = Fleet.open(workdir, data=D)
        file_sets = [cacheable_working_set(x.file_meta, res)
                     for x in opened.shards]
        assert budget < sum(file_sets), (budget, file_sets)
        log(f"fleet cache budget {budget} B against the shards' cacheable "
            f"working sets {file_sets} B ({sum(file_sets)} B together)")

        streams = make_streams(D.n, args.seed + 9, FLEET_BATCHES, BATCH)
        sub_batches = 0
        served, reports, plans = {}, {}, {}
        plain = {"torch": 0, "numpy": 0}
        torch_fn, numpy_fn = FR.fused_descent_torch, FR.fused_descent_ref

        def counted(fn, what):
            def call(*a, **kw):
                plain[what] += 1
                return fn(*a, **kw)
            return call
        FR.fused_descent_torch = counted(torch_fn, "torch")
        FR.fused_descent_ref = counted(numpy_fn, "numpy")
        FK.reset_launches()                   # the fleet's path starts here
        try:
            for name, idx in streams.items():
                batches = np.split(keys[idx], FLEET_BATCHES)
                sub_batches += sum(len(opened.shard_map.sub_batches(b))
                                   for b in batches)
                with opened.serve() as svc:
                    plans[name] = svc.plan.to_dict()
                    t0 = time.perf_counter()
                    out = svc.lookup_batches(batches)
                    wall = time.perf_counter() - t0
                    shards = []
                    for i, sh in enumerate(svc.services):
                        st = sh.stats
                        assert sh.device.type == "cuda" and sh.device_active, i
                        assert st.device_batches == st.batches, (i, st)
                        shards.append({
                            "shard": i, "batches": int(st.batches),
                            "queries": int(st.queries),
                            "hit_rate": st.hit_rate,
                            "descent_seconds": st.descent_seconds,
                            "cache_bytes": [c * sh.page_bytes for c in
                                            sh.cache.cap_pages]})
                served[name] = np.concatenate(out)
                reports[name] = {"lookups": len(idx), "wall_seconds": wall,
                                 "lookups_per_s": len(idx) / wall,
                                 "shards": shards}
        finally:
            FR.fused_descent_torch, FR.fused_descent_ref = torch_fn, numpy_fn
        launches = FK.launches()              # ... and ends here
        if launches != sub_batches or any(plain.values()):
            raise AssertionError(f"fleet: {launches} fused_descent launches "
                                 f"for {sub_batches} shard sub-batches, "
                                 f"plain descents {plain}")
        for name, r in reports.items():
            log(f"fleet stream {name}: " + json.dumps(r))
        # the second stream's service weighs the first's persisted traffic
        for name, plan in plans.items():
            log(f"fleet cache plan of the {name} stream's service: "
                + json.dumps(plan))

        # -- what comes out is right -------------------------------------
        for name, idx in streams.items():
            check_ranges(served[name], idx, f"fleet {name}", FLEET_RECORD)
            with opened.serve(backend="numpy") as svc:
                ref = np.concatenate(svc.lookup_batches(
                    np.split(keys[idx], FLEET_BATCHES)))
            if not np.array_equal(served[name], ref):
                raise AssertionError(f"fleet {name}: cuda ranges != numpy "
                                     f"ranges")
        sample = streams["uniform"][:2000]
        if not np.array_equal(served["uniform"][:2000],
                              opened.lookup(keys[sample])):
            raise AssertionError("fleet ranges != Fleet.lookup")

        # -- failure isolation: one shard's disk dies after open ----------
        sick = FLEET_SHARDS // 2
        q = keys[streams["uniform"][:BATCH]]
        with opened.serve(persist_stats=False) as svc:
            want = svc.lookup(q)
        make, armed = dies_after_open_factory(opened.shards[sick].path)
        with opened.serve(persist_stats=False, backend_factories=make) as svc:
            armed["on"] = True
            try:
                svc.lookup(q)
            except ShardUnavailableError as e:
                assert e.shard == sick, e.shard
            else:
                raise AssertionError("a dead shard did not raise "
                                     "ShardUnavailableError")
            out, avail = svc.lookup(q, partial_results=True)
            routed = opened.shard_map.route(q) == sick
            assert routed.any() and svc.healthy == [
                i != sick for i in range(FLEET_SHARDS)], svc.healthy
            if not (np.array_equal(avail, ~routed)
                    and np.array_equal(out[avail], want[avail])
                    and (out[~avail] == -1).all()):
                raise AssertionError("partial results do not mask exactly "
                                     "the dead shard's keys")
        opened.close()
        fleet.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"fleet path: {2 * FLEET_BATCHES} batches, {sub_batches} shard "
        f"sub-batches, {launches} fused_descent launches, no plain descent; "
        f"ranges contain every record, equal the numpy backend's, and a "
        f"2000-key sample equals Fleet.lookup; a shard dead after open "
        f"raises ShardUnavailableError and partial results mask exactly its "
        f"{int(routed.sum())} of {BATCH} keys")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the attention kernels against their plain versions
# ---------------------------------------------------------------------------
def check_attention_kernels(device, seed: int, card: str) -> dict:
    """Every decode and flash case: kernel == plain version within
    ATTN_TOL, then gemma2's windowed decode timed at a 32,768-key cache
    → the largest |kernel − plain| of the outputs per kernel."""
    import torch

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    rng = np.random.default_rng(seed + 8)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dt)

    errs = {"decode_attention": 0.0, "flash_attention": 0.0}

    def check_decode(got, want, dt: str, what: str) -> None:
        (o, m, l), (po, pm, pl) = got, want
        tol = ATTN_TOL[dt]
        eo = float((o - po).abs().max())
        em = float((m - pm).abs().max())
        el = float(((l - pl).abs() / pl.clamp_min(1.0)).max())
        errs["decode_attention"] = max(errs["decode_attention"], eo)
        if not (eo <= tol["o"] and em <= tol["m"] and el <= tol["l"]):
            raise AssertionError(
                f"decode_attention {what} {dt}: |o| err {eo:.3e}, |m| err "
                f"{em:.3e}, l rel err {el:.3e} (limits {tol})")

    def check_flash(o, want, dt: str, case) -> None:
        err = float((o.float() - want).abs().max())
        errs["flash_attention"] = max(errs["flash_attention"], err)
        lim = ATTN_TOL[dt]["flash"]
        if not err <= lim:
            raise AssertionError(f"flash_attention {case} {dt}: max abs "
                                 f"err {err:.3e} (limit {lim})")

    n_dec = 0
    for Hq, Hkv in DECODE_PAIRS:
        for D in DECODE_D:
            for S in DECODE_S:
                for dt in (torch.bfloat16, torch.float32):
                    R, G = DECODE_B * Hkv, Hq // Hkv
                    q, k, v = (randn((R, G, D), dt), randn((R, S, D), dt),
                               randn((R, S, D), dt))
                    lens = rng.integers(1, S + 1, DECODE_B)
                    lens[0] = 0                 # one batch row of length 0
                    lt = torch.from_numpy(np.repeat(lens, Hkv).astype(
                        np.int32)).to(device)
                    got = decode_attention_cuda(q, k, v, lt)
                    want = decode_attention_ref(q, k, v, lt)
                    torch.cuda.synchronize()
                    check_decode(got, want, str(dt).split(".")[-1],
                                 f"Hq={Hq} Hkv={Hkv} D={D} S={S}")
                    n_dec += 1
                    del q, k, v, got, want
    for group in DECODE_GROUPS:         # the bf16 kernel's groups, edges
        for D in EDGE_D:
            for S in DECODE_EDGE_S:
                R, bf = DECODE_B * 2, torch.bfloat16
                q, k, v = (randn((R, group, D), bf), randn((R, S, D), bf),
                           randn((R, S, D), bf))
                lens = rng.integers(1, S + 1, DECODE_B)
                lens[1], lens[2] = 0, S
                lt = torch.from_numpy(np.repeat(lens, 2).astype(
                    np.int32)).to(device)
                got = decode_attention_cuda(q, k, v, lt)
                want = decode_attention_ref(q, k, v, lt)
                torch.cuda.synchronize()
                check_decode(got, want, "bfloat16",
                             f"group={group} D={D} S={S}")
                n_dec += 1
                del q, k, v, got, want
    n_dec += check_windowed_decode(device, rng, randn, check_decode, card)
    n_dec += check_multi_token_decode(device, rng, randn, check_decode, card)
    n_fl = 0
    edges = [dict(B=2, Hq=4, Hkv=2, Sq=Sq, Skv=Sq + extra, D=D)
             for Sq in FLASH_EDGE_SQ for extra in FLASH_EDGE_EXTRA
             for D in EDGE_D]
    for case in (*edges, *FLASH_WINDOWED):   # the bf16 kernel alone
        c = dict(case)
        B, Hq, Hkv, Sq, Skv, D = (c.pop(x) for x in ("B", "Hq", "Hkv", "Sq",
                                                     "Skv", "D"))
        q = randn((B, Hq, Sq, D), torch.bfloat16)
        k = randn((B, Hkv, Skv, D), torch.bfloat16)
        v = randn((B, Hkv, Skv, D), torch.bfloat16)
        o = flash_attention_cuda(q, k, v, causal=True, **c)
        want = attention_ref(q, k, v, causal=True, **c)
        torch.cuda.synchronize()
        check_flash(o, want, "bfloat16", case)
        n_fl += 1
        del q, k, v, o, want
    for case in FLASH_CASES:
        c = {"causal": True, **case}
        B, Hq, Hkv, Sq, Skv, D = (c.pop(x) for x in ("B", "Hq", "Hkv", "Sq",
                                                     "Skv", "D"))
        for dt in (torch.bfloat16, torch.float32):
            q = randn((B, Hq, Sq, D), dt)
            k, v = randn((B, Hkv, Skv, D), dt), randn((B, Hkv, Skv, D), dt)
            o = flash_attention_cuda(q, k, v, **c)
            want = attention_ref(q, k, v, **c)
            torch.cuda.synchronize()
            check_flash(o, want, str(dt).split(".")[-1], case)
            n_fl += 1
            del q, k, v, o, want
    log(f"attention check: {n_dec} decode cases, max |o| err "
        f"{errs['decode_attention']:.3e}; {n_fl} flash cases, max abs err "
        f"{errs['flash_attention']:.3e}; float32 within "
        f"{ATTN_TOL['float32']}, bfloat16 within {ATTN_TOL['bfloat16']} "
        f"(TF32 off for the float32 plain versions)")
    return errs


def check_windowed_decode(device, rng, randn, check_decode,
                          card: str) -> int:
    """gemma2's decode at its real heads, window and softcap, through
    the CUDA-core kernel (float32) and the tensor-core kernel (bf16, its
    queries scaled by 4 so the scores reach where the cap bends them), each
    row length drawn from 1..S with one row of length 0 and one at S; then
    the bf16 kernel timed at B = 8 x 32,768 against its bound over the
    4,096 live keys → the number of cases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_ref)
    cfg = get_config(WINDOW_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    win, cap = cfg.sliding_window, cfg.attn_softcap
    n = 0
    for S in WINDOW_CACHES:
        for dt in (torch.float32, torch.bfloat16):
            R, G = DECODE_B * Hkv, Hq // Hkv
            q = randn((R, G, D), dt)
            if dt == torch.bfloat16:
                q = q * 4
            k, v = randn((R, S, D), dt), randn((R, S, D), dt)
            lens = rng.integers(1, S + 1, DECODE_B)
            lens[0], lens[-1] = 0, S
            lt = torch.from_numpy(np.repeat(lens, Hkv).astype(
                np.int32)).to(device)
            got = decode_attention_cuda(q, k, v, lt, window=win,
                                        softcap=cap)
            want = decode_attention_ref(q, k, v, lt, window=win,
                                        softcap=cap)
            torch.cuda.synchronize()
            check_decode(got, want, str(dt).split(".")[-1],
                         f"{WINDOW_ARCH} window={win} softcap={cap} S={S}")
            n += 1
            del q, k, v, got, want
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    decode_numbers(8, WINDOW_CACHES[-1], [WINDOW_CACHES[-1]] * 8, cfg, card,
                   device, gen, window=win, softcap=cap)
    return n


def check_multi_token_decode(device, rng, randn, check_decode,
                             card: str) -> int:
    """Several new tokens a step, folded into group·Sq query rows as
    ``decode_attention`` folds them: the kernel at MULTI_CASES' heads
    (20 rows over two m-tiles, 64 rows, 70 rows over two row tiles,
    gemma2's window and softcap at 16 rows), f32 and bf16, caches MULTI_S
    with a row of length 0 and one at S; then the bf16 kernel timed at
    qwen3-14b's heads (B = 4, cache 4,096) for Sq in MULTI_TIMED → the
    number of cases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_ref)
    n = 0
    for arch, sq in MULTI_CASES:
        cfg = get_config(arch)
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        opts = dict(window=cfg.sliding_window, softcap=cfg.attn_softcap)
        R, rows = DECODE_B * Hkv, Hq // Hkv * sq
        for S in MULTI_S:
            for dt in (torch.float32, torch.bfloat16):
                # q (B, Hq, Sq, D) folded: row (b, kv head), query g·Sq + s
                q = randn((DECODE_B, Hq, sq, D), dt).reshape(R, rows, D)
                if dt == torch.bfloat16 and opts["softcap"]:
                    q = q * 4                # scores where the cap bends
                k, v = randn((R, S, D), dt), randn((R, S, D), dt)
                lens = rng.integers(1, S + 1, DECODE_B)
                lens[0], lens[-1] = 0, S
                lt = torch.from_numpy(np.repeat(lens, Hkv).astype(
                    np.int32)).to(device)
                got = decode_attention_cuda(q, k, v, lt, **opts)
                want = decode_attention_ref(q, k, v, lt, **opts)
                torch.cuda.synchronize()
                check_decode(got, want, str(dt).split(".")[-1],
                             f"{arch} Sq={sq} ({rows} rows) S={S} {opts}")
                n += 1
                del q, k, v, got, want
    cfg = get_config(LLM_ARCH)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    for sq in MULTI_TIMED:
        decode_numbers(MULTI_TIMED_B, MULTI_TIMED_S,
                       [MULTI_TIMED_S] * MULTI_TIMED_B, cfg, card, device,
                       gen, sq=sq)
    return n


# ---------------------------------------------------------------------------
# phase 11: the LLM serving path at qwen3-14b's full width
# ---------------------------------------------------------------------------
def queued_device_ms(fn, n: int, before=None) -> float:
    """Device time per call of ``n`` calls of ``fn`` (each after
    ``before()``, when given) from a CUDA-event pair around them, the
    calls queued behind a device sleep so the card reaches them only
    after the host has enqueued every one: no host gap is timed, and no
    profiler trace is needed → milliseconds.  Until the host's enqueue
    fits inside the sleep, the sleep doubles and the calls halve (a call
    of many small ops can fill the card's launch queue, and the host then
    waits for the sleep itself)."""
    import torch
    for _ in range(3):
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(6):
        s0, s1, e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(4))
        t0 = time.perf_counter()
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        e0.record()
        for _ in range(n):
            if before is not None:
                before()
            fn()
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < s0.elapsed_time(s1):
            return e0.elapsed_time(e1) / n
        cycles *= 2
        n = max(1, n // 2)
    raise AssertionError(f"the host's enqueue of {n} calls outran a "
                         f"{cycles // 2}-cycle sleep")


def measure_hbm(device) -> tuple:
    """(ℓ, B) of the card's memory: ℓ the device time of one 4 KiB
    device-to-device copy (200 copies queued back to back: a CUDA-event
    pair around one copy alone would time the host's enqueue), B the
    bytes per second of a 2 GiB copy (CUDA events around back-to-back
    copies)."""
    import torch
    src = torch.ones(HBM_SMALL, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ell = queued_device_ms(lambda: dst.copy_(src), 200) / 1e3
    src = torch.ones(HBM_LARGE, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    bw = HBM_LARGE / (time_launches(lambda: dst.copy_(src), 5, 5) / 1e3)
    del src, dst
    return ell, bw


def device_share(fn, n: int, attempts: int = 3) -> tuple:
    """Wall per call of ``n`` synchronised calls of ``fn`` under the
    profiler, the share of it the card was busy (device rows summed) and
    the device rows by time → (wall s, busy share, [(name, us per call)]).
    A trace may come back with no device row: up to ``attempts`` traces
    are taken (each calls ``fn`` ``n`` times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
        rows = sorted(((e.key, e.self_device_time_total / n)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        if rows:
            break
    busy = sum(us for _, us in rows) / 1e6 / wall if rows else None
    return wall, busy, rows


def log_share(what: str, share: tuple) -> None:
    wall, busy, rows = share
    if busy is None:
        log(f"{what}: wall {wall * 1e3:.3f} ms per call under the profiler;"
            f" device busy share not measured (no trace held a device row)")
        return
    top = "; ".join(f"{name[:60]} {us:.1f} us" for name, us in rows[:8])
    log(f"{what}: wall {wall * 1e3:.3f} ms per call under the profiler, "
        f"device busy {busy:.4f} of it (idle {1 - busy:.4f}); top device "
        f"rows per call: {top}")


def steps_to_finish(lengths, batch: int, out_tokens: int) -> int:
    """Decode steps the serving loop needs until every request is done:
    a request holds its slot for its prompt plus ``out_tokens`` steps, and
    a freed slot takes the next request on the following step."""
    slots, nxt, done, step = [0] * batch, 0, 0, 0
    while done < len(lengths):
        for b in range(batch):
            if slots[b] == 0 and nxt < len(lengths):
                slots[b] = int(lengths[nxt]) + out_tokens
                nxt += 1
        step += 1
        for b in range(batch):
            if slots[b]:
                slots[b] -= 1
                done += slots[b] == 0
    return step


def attention_numbers(name: str, kern, plain, library, nbytes: int,
                      ops: int, n: int, card: str, shape: str) -> dict:
    """One attention kernel's device times at a shape, from queued CUDA
    events (no profiler trace): L2-cold (a 128 MiB rewrite before each
    call, whose own queued time is taken off) and back to back, beside its
    plain version, the SDPA yardstick and its bound → the kernels-line
    numbers."""
    cold, warm = queued_numbers({"ms": kern, "plain_ms": plain,
                                 "library_ms": library}, n)
    bound_ms, bound_by = roofline_bound(nbytes, ops, BF16_OPS_PER_S)
    sec = cold["ms"] / 1e3
    log(f"{name} at {shape} on {card}: achieved {ops / sec / 1e12:.3f} "
        f"TFLOP/s and {nbytes / sec / 1e9:.3f} GB/s L2-cold "
        f"({bound_ms / cold['ms']:.4f} of the bound)")
    log(f"{name} at {shape} on {card}: device time per call with the L2 "
        f"flushed {cold['ms'] * 1e3:.3f} us (plain torch "
        f"{cold['plain_ms'] * 1e3:.3f} us; SDPA {cold['library_ms'] * 1e3:.3f}"
        f" us), back to back {warm['ms'] * 1e3:.3f} us (plain "
        f"{warm['plain_ms'] * 1e3:.3f} us; SDPA "
        f"{warm['library_ms'] * 1e3:.3f} us); bound {bound_ms * 1e3:.3f} us "
        f"by {bound_by} ({nbytes} B, {ops} ops at the bf16 rate)")
    return {**cold, "bound_ms": bound_ms, "bound_by": bound_by}


def decode_numbers(B: int, S: int, lens, cfg, card: str, device,
                   gen, window: int | None = None,
                   softcap: float | None = None, sq: int = 1) -> dict:
    """The decode kernel on a (B, S) bf16 cache at ``cfg``'s heads for
    ``sq`` new tokens a row (folded into group·sq query rows), the rows
    live up to ``lens`` (their last ``window`` keys, when given), the
    scores capped by ``softcap`` when given.  The SDPA yardstick takes
    the same keys through a length mask shared by the new tokens; it has
    no softcap."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_ref)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G, R = Hq // Hkv * sq, B * Hkv       # query rows a (batch, kv head)
    bf = torch.bfloat16
    q = torch.randn((B, Hq, sq, D), generator=gen, device=device).to(bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(bf)
    lens = np.asarray(lens, dtype=np.int32)
    qg, kg, vg = q.reshape(R, G, D), k.reshape(R, S, D), v.reshape(R, S, D)
    lg = torch.from_numpy(np.repeat(lens, Hkv)).to(device)
    pos = torch.arange(S, device=device)[None, :]
    lt = torch.from_numpy(lens).to(device)[:, None]
    mask = pos < lt
    first = np.maximum(lens - (S if window is None else window), 0)
    if window is not None:
        mask &= pos >= lt - window
    mask = mask[:, None, None, :]
    live = int((lens - first).sum()) * Hkv      # (row, key) pairs read
    nbytes = 2 * live * D * 2 + R * G * D * 2 + R * G * (D + 2) * 4
    ops = 4 * G * D * live
    opts = dict(window=window, softcap=softcap)
    return attention_numbers(
        "decode_attention",
        lambda: decode_attention_cuda(qg, kg, vg, lg, **opts),
        lambda: decode_attention_ref(qg, kg, vg, lg, **opts),
        lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True),
        nbytes, ops, 50, card,
        f"B={B}" + ("" if sq == 1 else f" x {sq} new tokens")
        + f", S={S} (lengths {int(lens.min())}..{int(lens.max())}"
        + ("" if window is None else f", window {window}")
        + ("" if softcap is None else f", softcap {softcap}")
        + f"), Hq={Hq}, Hkv={Hkv}, D={D}, bf16")


def flash_numbers(B: int, S: int, cfg, card: str, device, gen) -> dict:
    """The flash kernel on a causal (B, S) bf16 prefill at qwen3-14b's
    heads, q in the model's (B, S, H, D) layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    q = torch.randn((B, S, Hq, D), generator=gen, device=device).to(bf) \
        .transpose(1, 2)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=device).to(bf) \
        .transpose(1, 2)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=device).to(bf) \
        .transpose(1, 2)
    pairs = B * Hq * S * (S + 1) // 2           # live (query, key) pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    ops = 4 * D * pairs
    return attention_numbers(
        "flash_attention", lambda: flash_attention_cuda(q, k, v),
        lambda: attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes, ops, 10, card, f"B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, "
        f"bf16, causal")


def multi_token_agree(got, want, vocab: int, what: str) -> str:
    """The last new token's logits of a decode step of several tokens
    against a prefill of the prompt and them, at its position: within
    ECHO_TOL of max |logit|, top-1 equal where prefill's top-2 margin is
    larger → the line to log (raises where they disagree)."""
    import torch
    got, want = got.float()[:, :vocab], want.float()[:, :vocab]
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) / scale > ECHO_TOL
    same = got.argmax(-1) == want.argmax(-1)
    how = (f"max |logit| err {err:.4e} of max |logit| {scale:.4f} (limit "
           f"{ECHO_TOL}); top-1 equal on {int(same.sum())} of "
           f"{got.shape[0]} rows ({int(sure.sum())} with a top-2 margin "
           f"above the limit)")
    if not (err <= ECHO_TOL and bool(same[sure].all())
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what}: the last new token's logits of a "
                             f"{MULTI_NEW}-token decode step disagree with "
                             f"prefill's: {how}")
    return how


def llm_phase(args, device, card: str, errs: dict) -> list:
    """Phase 11: qwen3-14b at full width, LLM_LAYERS deep, in bf16 on the
    card: prefill through ``make_prefill_step``, the port's serving loop, the
    same prompt through decode against prefill, the page table on the
    ``h100_hbm`` profile, then each attention kernel's numbers → the two
    kernels-line entries."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import PROFILES
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.kernels.flash_attention import ops as AO
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.kvcache import PagedKVCache

    ell, bw = measure_hbm(device)
    hbm = PROFILES["h100_hbm"]
    log(f"h100_hbm on {card}: measured latency {ell * 1e6:.3f} us (per 4 KiB "
        f"copy, queued), bandwidth {bw:.6e} B/s (2 GiB copies); profile "
        f"constants {hbm.latency * 1e6:.3f} us, {hbm.bandwidth:.6e} B/s")

    cfg = get_config(LLM_ARCH).scaled(n_layers=LLM_LAYERS)
    log(f"reduced: serving {cfg.name} at {LLM_LAYERS} of its 40 layers "
        f"(full width; the run's time limit, for phase 15)")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff},"
        f" vocab {cfg.vocab}; {n_params} parameters in {cfg.dtype} "
        f"({n_params * 2} B) drawn on the card in {t_init:.1f} s (seed "
        f"{args.seed}); param_count {cfg.param_count()}")
    rng = np.random.default_rng(args.seed + 9)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    L = cfg.n_layers

    def forbid(what):
        def plain_on_card(*a, **kw):
            raise AssertionError(f"the plain {what} ran on the LLM path")
        return plain_on_card

    saved = (AO.ref.attention_ref, DO.ref.decode_attention_ref)
    AO.ref.attention_ref = forbid("flash attention")
    DO.ref.decode_attention_ref = forbid("decode attention")
    AK.reset_launches()
    DK.reset_launches()                 # the LLM path starts here
    try:
        prefill_calls, decode_steps = 0, 0
        for B, S in PREFILLS:
            toks = torch.from_numpy(rng.integers(
                1, cfg.vocab, (B, S)).astype(np.int32)).to(device)
            walls = []
            for _ in range(2):          # the first call warms the library
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = prefill(params, {"tokens": toks})
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                prefill_calls += 1
            lf = logits.float()
            assert logits.shape == (B, cfg.padded_vocab), logits.shape
            assert bool(torch.isfinite(lf[:, :cfg.vocab]).all())
            assert bool((lf[:, cfg.vocab:] == lf.new_tensor(-1e30)
                         .to(logits.dtype).float()).all())
            log(f"prefill B={B} S={S}: wall {walls[1]:.4f} s (first call "
                f"{walls[0]:.4f} s), {B * S / walls[1]:.1f} tokens/s; "
                f"last logits finite, the {cfg.padded_vocab - cfg.vocab} "
                f"padded columns -1e30")

        queue = launcher.make_queue(cfg, SERVE_REQUESTS, args.seed)
        steps = steps_to_finish([len(p) for p in queue], SERVE_BATCH,
                                launcher.OUT_TOKENS)
        res = launcher.run(cfg, params, requests=SERVE_REQUESTS, steps=steps,
                           batch=SERVE_BATCH, max_len=steps, device=device,
                           seed=args.seed)
        decode_steps += steps
        st = res.stats
        walls = np.asarray(st["step_walls_s"])
        assert st["completed"] == SERVE_REQUESTS, st
        assert sorted(res.tokens) == list(range(SERVE_REQUESTS))
        assert all(len(t) == launcher.OUT_TOKENS
                   and all(0 <= x < cfg.vocab for x in t)
                   for t in res.tokens.values()), res.tokens
        p95 = float(np.percentile(walls, 95))
        log(f"serving loop: {SERVE_REQUESTS} requests, batch {SERVE_BATCH}, "
            f"{steps} steps (max_len {steps}), {st['out_tokens']} output "
            f"tokens in {st['wall_s']:.4f} s: {st['tokens_per_s']:.3f} "
            f"output tokens/s, {SERVE_BATCH * steps / st['wall_s']:.3f} "
            f"decoded tokens/s (every slot); step wall mean "
            f"{walls.mean() * 1e3:.3f} ms, median "
            f"{np.median(walls) * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} ms")
        log(f"serving loop tokens: {json.dumps(res.tokens)}")

        # the same prompt through prefill and, token by token, decode
        toks = torch.from_numpy(rng.integers(
            1, cfg.vocab, (ECHO_BATCH, ECHO_LEN)).astype(np.int32)).to(device)
        want = prefill(params, {"tokens": toks}).float()[:, :cfg.vocab]
        prefill_calls += 1
        state = api.init_decode_state(cfg, params, ECHO_BATCH,
                                      ECHO_LEN + MULTI_NEW + SHARE_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(ECHO_LEN):
            got, state = decode(params, {"tokens": toks[:, t:t + 1]}, state,
                                t)
        torch.cuda.synchronize()
        t_echo = time.perf_counter() - t0
        decode_steps += ECHO_LEN

        # MULTI_NEW new tokens in one step against prefill of them all
        new = toks.new_tensor(rng.integers(1, cfg.vocab,
                                           (ECHO_BATCH, MULTI_NEW)))
        multi, state = decode(params, {"tokens": new}, state, ECHO_LEN)
        want_multi = prefill(params, {"tokens": torch.cat([toks, new], 1)})
        decode_steps, prefill_calls = decode_steps + 1, prefill_calls + 1
        multi_how = multi_token_agree(multi, want_multi, cfg.vocab,
                                      f"{cfg.name}")

        # where a decode step's and a prefill's time goes
        nxt = iter(range(ECHO_LEN + MULTI_NEW,
                         ECHO_LEN + MULTI_NEW + SHARE_STEPS))
        one = toks[:, -1:]
        dec_share = device_share(lambda: decode(params, {"tokens": one},
                                                state, next(nxt)),
                                 SHARE_STEPS)
        decode_steps += SHARE_STEPS
        B, S = PREFILLS[0]
        ptoks = toks.new_tensor(rng.integers(1, cfg.vocab, (B, S)))
        pre_share = device_share(lambda: prefill(params, {"tokens": ptoks}),
                                 1)
        prefill_calls += 1
        del state
    finally:
        AO.ref.attention_ref, DO.ref.decode_attention_ref = saved
    launches = {"flash_attention": AK.launches(),
                "decode_attention": DK.launches()}    # ... and ends here
    expect = {"flash_attention": L * prefill_calls,
              "decode_attention": L * decode_steps}
    if launches != expect:
        raise AssertionError(f"LLM path launches {launches}, expected "
                             f"{expect}")
    got = got.float()[:, :cfg.vocab]
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) / scale > ECHO_TOL
    same = got.argmax(-1) == want.argmax(-1)
    log(f"decode vs prefill on one {ECHO_BATCH} x {ECHO_LEN} prompt: max "
        f"|logit| err {err:.4e} of max |logit| {scale:.4f} (limit "
        f"{ECHO_TOL}); top-1 equal on {int(same.sum())} of {ECHO_BATCH} rows "
        f"({int(sure.sum())} with a top-2 margin above the limit); "
        f"{ECHO_LEN} decode steps in {t_echo:.3f} s "
        f"({ECHO_BATCH * ECHO_LEN / t_echo:.3f} decoded tokens/s)")
    if not (err <= ECHO_TOL and bool(same[sure].all())
            and bool(torch.isfinite(got).all())):
        raise AssertionError("decode's last logits disagree with prefill's")
    log(f"{cfg.name} decode of {MULTI_NEW} new tokens in one step after the "
        f"{ECHO_BATCH} x {ECHO_LEN} prompt vs prefill of "
        f"{ECHO_LEN + MULTI_NEW} tokens, at the last new token on {card}: "
        f"{multi_how}")
    log_share(f"decode step (B={ECHO_BATCH}, cache {ECHO_LEN})", dec_share)
    log_share(f"prefill (B={PREFILLS[0][0]}, S={PREFILLS[0][1]})",
              pre_share)
    log(f"LLM path: {prefill_calls} prefill calls, {decode_steps} decode "
        f"steps, launches {launches} (exact: {L} per prefill call and per "
        f"decode step); no plain attention ran")

    # the page table the loop's requests held, tuned for the card's memory
    pool = PagedKVCache(n_pages=launcher.N_PAGES)
    for i, p in enumerate(queue):
        pool.add_sequence(i)
        pool.append_tokens(i, len(p) + launcher.OUT_TOKENS)
    cost = pool.modeled_lookup_cost("h100_hbm", device=device)
    log(f"page table of {SERVE_REQUESTS} requests tuned for h100_hbm: "
        f"{json.dumps(cost)}")
    if not (hbm.latency / HBM_FACTOR <= ell <= hbm.latency * HBM_FACTOR
            and hbm.bandwidth / HBM_FACTOR <= bw
            <= hbm.bandwidth * HBM_FACTOR):
        raise AssertionError(f"the h100_hbm profile ({hbm.latency:.3e} s, "
                             f"{hbm.bandwidth:.3e} B/s) is more than "
                             f"{HBM_FACTOR}x off the card's ({ell:.3e} s, "
                             f"{bw:.3e} B/s)")

    log(f"LLM path peak memory: {torch.cuda.max_memory_allocated(device)} B "
        f"(the weights {n_params * 2} B)")

    # -- each kernel at the path's shapes --------------------------------------
    del params, want, got
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(args.seed + 10)
    dec = decode_numbers(SERVE_BATCH, steps, [steps] * SERVE_BATCH, cfg,
                         card, device, gen)     # the loop's last step
    decode_numbers(ECHO_BATCH, ECHO_LEN, [ECHO_LEN] * ECHO_BATCH, cfg, card,
                   device, gen)
    decode_numbers(8, 32768, [32768] * 8, cfg, card, device, gen)
    fl = flash_numbers(*PREFILLS[0], cfg, card, device, gen)
    flash_numbers(*PREFILLS[1], cfg, card, device, gen)
    entries = []
    for name, t in (("decode_attention", dec), ("flash_attention", fl)):
        source, replaces = ATTN_KERNELS[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    return entries


# ---------------------------------------------------------------------------
# phase 14: the training path at qwen3-14b's full width
# ---------------------------------------------------------------------------
def write_store(path: str, vocab: int, seed: int) -> float:
    """STORE_SAMPLES records of STORE_LENGTHS tokens, token ranks drawn by
    Zipf's law (exponent TOKEN_ZIPF) over ``vocab`` and mapped to token
    ids by a random permutation, written with ``write_token_store`` →
    the write's wall (the records are made in bulk first)."""
    from repro_torch.data import write_token_store
    rng = np.random.default_rng(seed)
    lens = rng.integers(*STORE_LENGTHS, STORE_SAMPLES)
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64)
                    ** -TOKEN_ZIPF)
    ranks = np.searchsorted(cdf, rng.random(int(lens.sum())) * cdf[-1])
    tokens = rng.permutation(vocab).astype(np.int32)[
        np.minimum(ranks, vocab - 1)]
    samples = np.split(tokens, np.cumsum(lens)[:-1])
    t0 = time.perf_counter()
    write_token_store(path, samples)
    return time.perf_counter() - t0


def check_store(path: str, seed: int):
    """Open the store on azure_ssd (its index tuned by AirTune) and hold
    STORE_GETS random ``get``s against the records as written → (store,
    open wall)."""
    from repro_torch.data import ShardedTokenStore
    t0 = time.perf_counter()
    store = ShardedTokenStore(path, profile="azure_ssd")
    t_open = time.perf_counter() - t0
    offs = np.load(os.path.join(path, "offsets.npy"))
    rng = np.random.default_rng(seed + 1)
    with open(os.path.join(path, "shard0.tokens"), "rb") as f:
        for i in rng.integers(0, store.n, STORE_GETS):
            f.seek(int(offs[i]))
            want = np.frombuffer(f.read(int(offs[i + 1] - offs[i])), np.int32)
            if not np.array_equal(store.get(int(i)), want):
                raise AssertionError(f"store.get({i}) != its record")
    return store, t_open


def check_attention_grads(device, cfg, seed: int, card: str) -> float:
    """``FlashAttention`` at the training shape against the plain version
    in float32: its output (the kernel's forward) within the bf16 flash
    limit, then dq, dk, dv (the PyTorch backward, which recomputes the
    output itself) against autograd through the plain version → the
    forward's max abs error."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.layers import FlashAttention
    B, S, Hq, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    bf = torch.bfloat16
    q = randn(B, S, Hq, D).to(bf).transpose(1, 2).requires_grad_()
    k = randn(B, S, Hkv, D).to(bf).transpose(1, 2).requires_grad_()
    v = randn(B, S, Hkv, D).to(bf).transpose(1, 2).requires_grad_()
    do = randn(B, Hq, S, D).to(bf)
    out = FlashAttention.apply(q, k, v, True, None, None, None)
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_in)
    fwd_err = float((out.detach().float() - ref_out.detach()).abs().max())
    fwd_lim = ATTN_TOL["bfloat16"]["flash"]
    log(f"attention forward at B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, "
        f"bf16, causal on {card}: FlashAttention (the flash kernel) vs the "
        f"plain version in float32: max abs err {fwd_err:.4e} (limit "
        f"{fwd_lim})")
    if not fwd_err <= fwd_lim:
        raise AssertionError(f"flash_attention at the training shape: max "
                             f"abs err {fwd_err:.3e} (limit {fwd_lim})")
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref_out, ref_in, do.float())
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((g.float() - w).abs().max() / w.abs().max())
    log(f"attention gradients at B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, "
        f"bf16, causal on {card}: FlashAttention's PyTorch backward vs "
        f"autograd through the plain version in float32: max err / max "
        f"|grad| {json.dumps(errs)} (limit {GRAD_TOL})")
    if not max(errs.values()) <= GRAD_TOL:
        raise AssertionError(f"attention gradients off: {errs}")
    return fwd_err


def leaf_digests(tree) -> dict:
    """sha1 of each leaf's bytes, by the checkpoint's leaf names (the
    leaves hashed in parallel: hashlib releases the GIL)."""
    import hashlib

    import torch

    from repro_torch.train.checkpoint import _leaf_paths

    def digest(leaf):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return hashlib.sha1(t.numpy().data).hexdigest()

    leaves = _leaf_paths(tree)
    with ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(digest, [leaf for _, leaf in leaves]))
    return {name: d for (name, _), d in zip(leaves, digests)}


def train_model_flops(cfg, B: int, S: int) -> tuple:
    """Model FLOPs of a training step on a (B, S) batch: 6 N for the
    matmul parameters (the embedding is a gather) per token, and
    attention's live causal pairs x 4D forward, three times over for the
    backward → (FLOPs, N)."""
    n_mm = cfg.param_count() - cfg.vocab * cfg.d_model - cfg.d_model
    pairs = B * cfg.n_heads * S * (S + 1) // 2
    return 6 * n_mm * B * S + 3 * 4 * cfg.hd * pairs * cfg.n_layers, n_mm


def train_phase(args, device, card: str) -> int:
    """Phase 14: a token store written, tuned and read back; the attention
    gradient at the training shape; then the port's ``launch.train.run``
    at qwen3-14b's full width, TRAIN_LAYERS deep, through the supervisor
    with a host killed after step TRAIN_KILL_AFTER and a restore from the
    step-TRAIN_CKPT_EVERY checkpoint → the flash launches of the run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.kernels.flash_attention import ops as AO
    from repro_torch.launch import train as TL

    cfg = get_config(LLM_ARCH).scaled(n_layers=TRAIN_LAYERS)
    log(f"reduced: training {cfg.name} at {TRAIN_LAYERS} of its 40 layers "
        f"(full width; the run's time limit and one card's memory)")
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        data = os.path.join(work, "data")
        t_write = write_store(data, cfg.vocab, args.seed + 14)
        store, t_open = check_store(data, args.seed + 14)
        size = sum(os.path.getsize(os.path.join(data, f))
                   for f in os.listdir(data))
        log(f"token store: {store.n} records, {int(store.offs[-1])} token "
            f"bytes, {size} B on disk; write {t_write:.3f} s, open and tune "
            f"{t_open:.3f} s; {STORE_GETS} random gets equal their records;"
            f" sample index {store.tune.design.describe()} (cost "
            f"{store.tune.cost * 1e6:.3f} us)")
        store.close()

        fwd_err = check_attention_grads(device, cfg, args.seed + 15, card)

        saved, restored, killed, traced = {}, {}, [], []
        real_save, real_restore = TL.save_checkpoint, TL.restore_checkpoint

        def save(path, tree, *, step, **kw):
            if step == TRAIN_CKPT_EVERY:
                saved.update(leaf_digests(tree))
            return real_save(path, tree, step=step, **kw)

        def restore(path, like, *, step, **kw):
            tree, stats = real_restore(path, like, step=step, **kw)
            restored.update(leaf_digests(tree))
            return tree, stats

        class KillAfter(TL.TrainingSupervisor):
            def run(self, state, step_fn, n_steps, start_step=0):
                def step(st, i):
                    if i == TRAIN_TRACED and not traced:
                        # one traced call; the step updates ``st`` in place
                        traced.append(device_share(lambda: step_fn(st, i), 1,
                                                   attempts=1))
                    else:
                        st = step_fn(st, i)
                    if i == TRAIN_KILL_AFTER and not killed:
                        killed.append(f"host{TL.HOSTS - 1}")
                        self.monitor.kill(killed[-1])
                    return st
                return super().run(state, step, n_steps, start_step)

        def plain_on_card(*a, **kw):
            raise AssertionError("the plain flash attention ran on the "
                                 "training path")

        targs = TL.parse_args([
            "--arch", LLM_ARCH, "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--workdir",
            os.path.join(work, "run"), "--data", data])
        patched = (TL.save_checkpoint, TL.restore_checkpoint,
                   TL.TrainingSupervisor, AO.ref.attention_ref)
        TL.save_checkpoint, TL.restore_checkpoint = save, restore
        TL.TrainingSupervisor = KillAfter
        AO.ref.attention_ref = plain_on_card
        torch.cuda.reset_peak_memory_stats(device)
        AK.reset_launches()             # the training path starts here
        try:
            res = TL.run(cfg, targs, device,
                         init=torch.Generator(device=device).manual_seed(0))
        finally:
            (TL.save_checkpoint, TL.restore_checkpoint,
             TL.TrainingSupervisor, AO.ref.attention_ref) = patched
        launches = AK.launches()        # ... and ends here
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    calls = len(res.losses)             # step calls, the replayed included
    expect = 2 * cfg.n_layers * calls   # each block's forward and recompute
    events = [(e["event"], e.get("step", e.get("from_step"))) for e in
              res.log if e["event"] != "straggler"]
    want_events = [("checkpoint", TRAIN_CKPT_EVERY),
                   ("failure", TRAIN_KILL_AFTER + 1),
                   ("restart", TRAIN_CKPT_EVERY),
                   ("checkpoint", 2 * TRAIN_CKPT_EVERY)]
    replayed = TRAIN_KILL_AFTER + 1 - TRAIN_CKPT_EVERY
    if events != want_events or calls != TRAIN_STEPS + replayed:
        raise AssertionError(f"supervisor events {res.log}, {calls} step "
                             f"calls")
    if not saved or restored != saved:
        raise AssertionError("a restored leaf differs from the tree saved "
                             f"at step {TRAIN_CKPT_EVERY}")
    if launches != expect:
        raise AssertionError(f"training launched the flash kernel "
                             f"{launches} times, expected {expect}")
    if not np.isfinite(res.losses).all():
        raise AssertionError(f"losses {res.losses}")

    walls = np.asarray(res.step_walls_s)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, n_mm = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    med = float(np.median(walls))
    ck = res.checkpoints
    log(f"training {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}), {cfg.n_layers} of 40 layers, "
        f"{cfg.param_count()} parameters, bf16, remat, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} on {card}: {res.steps} steps "
        f"({calls} step calls, {replayed} replayed after the restore)")
    log(f"training losses {json.dumps(res.losses)}; grad norms "
        f"{json.dumps(res.grad_norms)}")
    log(f"training step wall mean {walls.mean():.4f} s, median {med:.4f} s "
        f"(first {walls[0]:.4f} s); {tokens / med:.1f} tokens/s at the "
        f"median, the launcher's {res.tokens_per_s:.1f} tokens/s over "
        f"{res.wall_s:.3f} s (checkpoints and the restore included); "
        f"{flops / med / 1e12:.3f} TFLOP/s of model FLOPs ({flops:.4e} a "
        f"step: 6 N tokens, N = {n_mm} matmul parameters, + attention's); "
        f"peak memory {peak} B ({peak / 2**30:.2f} GiB)")
    log_share(f"training step {TRAIN_TRACED} ({cfg.n_layers} layers, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ})", traced[0])
    wall, busy, rows = traced[0]
    if busy is not None:
        flash_us = sum(us for name, us in rows if "flash" in name)
        log(f"training step {TRAIN_TRACED}: the flash kernel {flash_us:.1f} "
            f"us of device time ({flash_us / 1e6 / wall:.4f} of the step's "
            f"wall)")
    log(f"checkpoints: saves {json.dumps(ck['save_s'])} s of "
        f"{json.dumps(ck['save_bytes'])} B; restore "
        f"{json.dumps(ck['restore_s'])} s reading "
        f"{json.dumps(ck['restore_bytes'])} B; {len(restored)} restored "
        f"leaves bit-equal to the step-{TRAIN_CKPT_EVERY} save (sha1)")
    log(f"training path: flash launches {launches} (exact: 2 x "
        f"{cfg.n_layers} layers x {calls} step calls, forward and remat "
        f"recompute); no plain attention ran; losses finite, "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
    return launches, fwd_err


# ---------------------------------------------------------------------------
# phase 15: the other families at their published widths
# ---------------------------------------------------------------------------
def family_launches(cfg) -> tuple:
    """Attention launches the family's serving path makes: (flash per
    prefill call, decode per decode step, flash per decode step, flash per
    decode-state init)."""
    from repro_torch.models import ssm
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers, cfg.n_layers, 0, 0
    if cfg.family == "hybrid":           # the shared block's applications
        n = ssm.n_shared_applications(cfg)
        return n, n, 0, 0
    if cfg.family == "audio":            # encoder; decoder self + cross
        return (cfg.encoder_layers + 2 * cfg.n_layers, cfg.n_layers,
                cfg.n_layers, cfg.encoder_layers)
    return 0, 0, 0, 0                    # rwkv: no attention


def family_batch(cfg, rng, B: int, S: int, device, patches: bool) -> dict:
    """Random tokens (B, S) and the family's stub inputs: whisper's
    frames (B, n_frames, d); llava's ``n_patches`` patch embeddings at
    distinct random positions when ``patches``."""
    import torch
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(device)}
    scale = cfg.padded_vocab ** -0.5     # the embedding rows' init scale
    if cfg.family == "audio":
        batch["frames"] = (torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)).to(device)
            .mul_(scale).to(cfg.torch_dtype))
    if cfg.family == "vlm" and patches:
        P = min(cfg.n_patches, S)
        batch["patch_embeds"] = (torch.from_numpy(rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)).to(device)
            .mul_(scale).to(cfg.torch_dtype))
        batch["patch_positions"] = torch.from_numpy(np.stack(
            [rng.choice(S, P, replace=False) for _ in range(B)])
            .astype(np.int32)).to(device)
    return batch


class FamilyProbe:
    """While active, counts the (token, expert) assignments each MoE
    routing group kept, and times every chunked linear scan (synchronised
    around it) with the largest |W| a chunk's cumulative log-decay
    reached: wrappers around ``layers._moe_group_dispatch`` and the scan
    the rwkv and ssm modules call.  For one instrumented prefill only: it
    synchronises."""

    def __init__(self):
        self.kept = self.assigned = 0
        self.scan_walls, self.max_w = [], 0.0

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from repro_torch.models import layers, linear_scan, rwkv, ssm
        real_disp, real_scan = (layers._moe_group_dispatch,
                                linear_scan.chunked_linear_scan)

        def dispatch(*a, **kw):
            out, keep = real_disp(*a, **kw)
            self.kept += int(keep.sum())
            self.assigned += keep.numel()
            return out, keep

        def scan(q, k, v, logw, state0, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_scan(q, k, v, logw, state0, **kw)
            torch.cuda.synchronize()
            self.scan_walls.append(time.perf_counter() - t0)
            C = kw.get("chunk", linear_scan.CHUNK)
            w = F.pad(logw.float(), (0, 0, 0, (-logw.shape[2]) % C))
            w = w.reshape(*w.shape[:2], -1, C, w.shape[-1]).cumsum(dim=3)
            self.max_w = max(self.max_w, float(w.abs().max()))
            return out

        self._mods = (layers, rwkv, ssm)
        self._saved = (real_disp, rwkv.chunked_linear_scan,
                       ssm.chunked_linear_scan)
        layers._moe_group_dispatch = dispatch
        rwkv.chunked_linear_scan = ssm.chunked_linear_scan = scan
        return self

    def __exit__(self, *exc):
        layers, rwkv, ssm = self._mods
        (layers._moe_group_dispatch, rwkv.chunked_linear_scan,
         ssm.chunked_linear_scan) = self._saved
        return False


class MoeRoutes:
    """While active, wraps the transformer's ``moe_ffn``: records each
    call's top-k experts and router top-k margin (in logit units) by
    layer, and, where ``pin(layer)`` is set, routes every token of the
    call to the experts it names (gates from the call's own router
    probabilities at those experts).  The decode check pins decode's
    routing to prefill's: a (token, expert) choice within bf16 rounding
    of the next may flip between the two paths, and one flipped token's
    FFN output then differs entirely (the JAX package's decode test leaves
    MoE out for this)."""

    def __init__(self, n_layers: int):
        self.n_layers, self.calls, self.seen, self.pin = n_layers, 0, [], None

    def __enter__(self):
        from repro_torch.models import layers, transformer
        real_ffn, real_route = transformer.moe_ffn, layers._route

        def moe_ffn(x, router_w, *w, top_k, capacity_factor):
            top = (x.float() @ router_w.float()).topk(top_k + 1, dim=-1)
            layer = self.calls % self.n_layers
            self.calls += 1
            self.seen.append((top.indices[:, :top_k], top.values[:, top_k - 1]
                              - top.values[:, top_k]))
            if self.pin is None:
                return real_ffn(x, router_w, *w, top_k=top_k,
                                capacity_factor=capacity_factor)
            pinned = self.pin(layer)

            def route(x_, r_, k_):
                probs, _, _ = real_route(x_, r_, k_)
                return probs, probs.gather(-1, pinned), pinned
            layers._route = route
            try:
                return real_ffn(x, router_w, *w, top_k=top_k,
                                capacity_factor=capacity_factor)
            finally:
                layers._route = real_route

        self._saved = (transformer, real_ffn)
        transformer.moe_ffn = moe_ffn
        return self

    def __exit__(self, *exc):
        transformer, real_ffn = self._saved
        transformer.moe_ffn = real_ffn
        return False


def serve_family(arch: str, layers, args, device, card: str) -> dict:
    """One family on the card in bf16: weights from ``init_params``,
    ``make_prefill_step`` twice at 1 x FAMILY_PREFILL (whisper: its 448-token
    context over 1,500 frames; llava: with its patches) and once
    instrumented, a FAMILY_ECHO prompt through prefill and token by token
    through decode (MoE at the no-drop capacity factor E / k), zamba2's
    launcher at the JAX launcher's defaults; exact attention launches →
    {kernel: launches} of the family's run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    full = cfg.n_layers
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
        log(f"reduced: {cfg.name} at {layers} of its {full} layers (full "
            f"width; one card's memory)")
    rng = np.random.default_rng(args.seed + 15)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name} [{cfg.family}] on {card}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}"
           + (" + shared" if cfg.shared_expert else "")
           if cfg.n_experts else "")
        + f"; {n_params} parameters in {cfg.dtype} ({n_params * 2} B) drawn"
        f" on the card in {t_init:.1f} s")
    per_prefill, dec_per_step, fl_per_step, fl_per_init = \
        family_launches(cfg)
    AK.reset_launches()
    DK.reset_launches()                 # the family's path starts here
    prefill = make_prefill_step(cfg)
    S = WHISPER_CONTEXT if cfg.family == "audio" else FAMILY_PREFILL
    batch = family_batch(cfg, rng, 1, S, device, patches=True)
    walls = []
    for _ in range(2):                  # the first call warms the library
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    lf = logits.float()
    assert logits.shape == (1, cfg.padded_vocab), logits.shape
    assert bool(torch.isfinite(lf[:, :cfg.vocab]).all())
    with FamilyProbe() as probe:        # one instrumented call
        prefill(params, batch)
    prefill_calls = 3
    extra = (f" over {cfg.n_frames} frames" if cfg.family == "audio" else
             f" with {batch['patch_embeds'].shape[1]} patch embeddings"
             if "patch_embeds" in batch else "")
    log(f"{cfg.name} prefill B=1 S={S}{extra} on {card}: wall "
        f"{walls[1]:.4f} s (first call {walls[0]:.4f} s), "
        f"{S / walls[1]:.1f} tokens/s")
    if probe.assigned:
        log(f"{cfg.name} prefill routing: {probe.assigned - probe.kept} of "
            f"{probe.assigned} (token, expert) assignments dropped by "
            f"capacity (share {1 - probe.kept / probe.assigned:.6f}, "
            f"capacity factor {cfg.capacity_factor})")
    if probe.scan_walls:
        sw = np.asarray(probe.scan_walls)
        log(f"{cfg.name} chunked scans in the instrumented prefill on "
            f"{card}: {len(sw)} calls, {sw.sum():.4f} s together, mean "
            f"{sw.mean() * 1e3:.3f} ms ({S // 32} chunk steps a call); "
            f"largest |W| a chunk reached {probe.max_w:.4f}")

    # the same prompt through prefill and, token by token, decode
    dcfg = cfg
    if cfg.n_experts:
        dcfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
        log(f"{cfg.name} decode check at capacity factor "
            f"{dcfg.capacity_factor} (E / k: no routing group drops an "
            f"assignment, so prefill and decode route alike; the JAX "
            f"package's decode test leaves MoE out for the drops)")
    B, n = FAMILY_ECHO
    echo = family_batch(cfg, rng, B, n, device, patches=False)
    toks = echo["tokens"]
    decode = make_decode_step(dcfg)
    decode_steps, inits = 0, 0

    def run_decode(routes=None, c=dcfg, p=params, step=decode):
        state = api.init_decode_state(c, p, B, n + MULTI_NEW,
                                      frames=echo.get("frames"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            if routes is not None:
                routes.step = t
            got, state = step(p, {"tokens": toks[:, t:t + 1]}, state, t)
        torch.cuda.synchronize()
        return got.float()[:, :cfg.vocab], time.perf_counter() - t0, state

    def agree(got, want):
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) / scale > ECHO_TOL
        same = got.argmax(-1) == want.argmax(-1)
        ok = (err <= ECHO_TOL and bool(same[sure].all())
              and bool(torch.isfinite(got).all()))
        return ok, (f"max |logit| err {err:.4e} of max |logit| {scale:.4f} "
                    f"(limit {ECHO_TOL}); top-1 equal on {int(same.sum())} "
                    f"of {B} rows ({int(sure.sum())} with a top-2 margin "
                    f"above the limit)")

    if not cfg.n_experts:
        want = make_prefill_step(dcfg)(params, echo).float()[:, :cfg.vocab]
        got, t_echo, state = run_decode()
        prefill_calls, decode_steps, inits = prefill_calls + 1, n, 1
        ok, how = agree(got, want)
        log(f"{cfg.name} decode vs prefill on one {B} x {n} prompt on "
            f"{card}: {how}; {n} decode steps in {t_echo:.3f} s "
            f"({B * n / t_echo:.3f} decoded tokens/s)")
        if cfg.family in ECHO_F32_FAMILIES:
            # the same weights, upcast, hold the scan forms to each other
            # without bf16's rounding, which this random model amplifies
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{cfg.name}: bf16 decode not finite")
            c32 = dcfg.scaled(dtype="float32")
            p32 = api.empty_params(c32, device)
            with torch.no_grad():
                for a, b in zip(p32.parameters(), params.parameters()):
                    a.copy_(b)
            want32 = make_prefill_step(c32)(p32, echo).float()[
                :, :cfg.vocab]
            got32, t32, _ = run_decode(c=c32, p=p32,
                                       step=make_decode_step(c32))
            prefill_calls, decode_steps, inits = (prefill_calls + 1,
                                                  decode_steps + n, inits + 1)
            ok, how = agree(got32, want32)
            log(f"{cfg.name} decode vs prefill in float32 (the bf16 weights "
                f"upcast) on one {B} x {n} prompt on {card}: {how}; {n} "
                f"decode steps in {t32:.3f} s; the bf16 check above is "
                f"reported, this one decides")
            del p32
    else:
        L = cfg.n_layers
        with MoeRoutes(L) as routes:
            want = make_prefill_step(dcfg)(params, echo).float()[
                :, :cfg.vocab]
            pre = [(e.reshape(B, n, -1), m.reshape(B, n))
                   for e, m in routes.seen]
            routes.seen = []
            free, t_echo, _ = run_decode()       # decode routes itself
            flips, flip_margin, margin_min = 0, 0.0, float("inf")
            for i, (e, _) in enumerate(routes.seen):
                t, layer = divmod(i, L)
                pe, pm = pre[layer][0][:, t], pre[layer][1][:, t]
                bad = (e != pe).any(dim=-1)
                flips += int(bad.sum())
                if bool(bad.any()):
                    flip_margin = max(flip_margin, float(pm[bad].max()))
                margin_min = min(margin_min, float(pm.min()))
            routes.pin = lambda layer: pre[layer][0][:, routes.step]
            pinned, t_pin, state = run_decode(routes)   # routed as prefill
        prefill_calls, decode_steps, inits = prefill_calls + 1, 2 * n, 2
        ok_free, how_free = agree(free, want)
        ok, how = agree(pinned, want)
        log(f"{cfg.name} routing, decode vs prefill on one {B} x {n} prompt"
            f" on {card}: {flips} of {B * n * L} (token, layer) choices "
            f"flipped (largest prefill top-{cfg.top_k} margin among them "
            f"{flip_margin:.4e} logits; smallest margin of any choice "
            f"{margin_min:.4e})")
        log(f"{cfg.name} decode routing itself vs prefill on {card}: "
            f"{how_free}; {n} decode steps in {t_echo:.3f} s "
            f"({B * n / t_echo:.3f} decoded tokens/s)")
        log(f"{cfg.name} decode routed as prefill vs prefill on {card}: "
            f"{how}; {n} decode steps in {t_pin:.3f} s")
        if flips == 0 and not ok_free:
            raise AssertionError(f"{cfg.name}: decode routed every token as "
                                 f"prefill did and still disagrees")
    if not ok:
        raise AssertionError(f"{cfg.name}: decode's last logits disagree "
                             f"with prefill's")
    if cfg.name in MULTI_FAMILIES:      # MULTI_NEW new tokens in one step
        new = family_batch(cfg, rng, B, MULTI_NEW, device,
                           patches=False)["tokens"]
        full = dict(echo, tokens=torch.cat([toks, new], 1))
        if cfg.n_experts:               # routed as prefill routes them
            with MoeRoutes(cfg.n_layers) as routes:
                want_m = make_prefill_step(dcfg)(params, full)
                pre_m = [e.reshape(B, n + MULTI_NEW, -1)[:, n:].reshape(
                    B * MULTI_NEW, -1) for e, _ in routes.seen]
                routes.pin = lambda layer: pre_m[layer]
                multi, state = decode(params, {"tokens": new}, state, n)
        else:
            want_m = make_prefill_step(dcfg)(params, full)
            multi, state = decode(params, {"tokens": new}, state, n)
        prefill_calls, decode_steps = prefill_calls + 1, decode_steps + 1
        how = multi_token_agree(multi, want_m, cfg.vocab, cfg.name)
        log(f"{cfg.name} decode of {MULTI_NEW} new tokens in one step after"
            f" the {B} x {n} prompt vs prefill of {n + MULTI_NEW} tokens, "
            f"at the last new token on {card}: {how}"
            + (" (routed as prefill)" if cfg.n_experts else ""))
    del state

    if cfg.family == "hybrid":          # the JAX launcher's default arch
        largs = launcher.parse_args(["--no-smoke"])
        if get_config(largs.arch, smoke=largs.smoke) != cfg:
            raise AssertionError(f"the launcher's default {largs.arch} is "
                                 f"not {cfg.name}")
        res = launcher.run(cfg, params, requests=largs.requests,
                           steps=largs.steps, batch=largs.batch,
                           max_len=largs.max_len, device=device)
        decode_steps += largs.steps
        inits += 1
        st = res.stats
        sw = np.asarray(st["step_walls_s"])
        if not (st["out_tokens"] > 0 and all(
                0 <= x < cfg.vocab for t in res.tokens.values() for x in t)):
            raise AssertionError(f"launcher run {st}")
        log(f"{cfg.name} launcher (--no-smoke: {largs.requests} requests, "
            f"batch {largs.batch}, {largs.steps} steps, max_len "
            f"{largs.max_len}) on {card}: {st['out_tokens']} output tokens, "
            f"{st['completed']} requests complete, {st['tokens_per_s']:.3f} "
            f"output tokens/s, {largs.batch * largs.steps / st['wall_s']:.3f}"
            f" decoded tokens/s; step wall median "
            f"{np.median(sw) * 1e3:.3f} ms, p95 "
            f"{np.percentile(sw, 95) * 1e3:.3f} ms")
    launches = {"flash_attention": AK.launches(),
                "decode_attention": DK.launches()}    # ... and ends here
    expect = {"flash_attention": per_prefill * prefill_calls
              + fl_per_step * decode_steps + fl_per_init * inits,
              "decode_attention": dec_per_step * decode_steps}
    if launches != expect:
        raise AssertionError(f"{cfg.name} launches {launches}, expected "
                             f"{expect}")
    peak = torch.cuda.max_memory_allocated(device)
    log(f"{cfg.name} path on {card}: {prefill_calls} prefill calls, "
        f"{decode_steps} decode steps, {inits} decode-state inits; "
        f"launches {launches} (exact); peak memory {peak} B "
        f"({peak / 2**30:.2f} GiB; the weights {n_params * 2} B)")
    del params, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_phase(args, device, card: str) -> dict:
    """Phase 15: every family of FAMILIES served on the card under
    ``torch.no_grad()``, the plain attention versions forbidden → the
    attention launches of the phase by kernel."""
    import torch

    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import ops as AO

    def forbid(what):
        def plain_on_card(*a, **kw):
            raise AssertionError(f"the plain {what} ran on a family path")
        return plain_on_card

    saved = (AO.ref.attention_ref, DO.ref.decode_attention_ref)
    AO.ref.attention_ref = forbid("flash attention")
    DO.ref.decode_attention_ref = forbid("decode attention")
    total = {"flash_attention": 0, "decode_attention": 0}
    try:
        with torch.no_grad():
            for arch, layers in FAMILIES:
                t0 = time.perf_counter()
                got = serve_family(arch, layers, args, device, card)
                for k in total:
                    total[k] += got[k]
                log(f"{arch} wall: {time.perf_counter() - t0:.1f} s")
    finally:
        AO.ref.attention_ref, DO.ref.decode_attention_ref = saved
    log(f"families path: launches {total}; no plain attention ran")
    return total


@contextlib.contextmanager
def plain_decode_forbidden(what: str):
    """The plain decode version raises while the block runs (the path's
    own calls); it is restored for the comparisons after."""
    from repro_torch.kernels.decode_attention import ops as DO

    def plain_on_card(*a, **kw):
        raise AssertionError(f"the plain decode attention ran on {what}")

    saved = DO.ref.decode_attention_ref
    DO.ref.decode_attention_ref = plain_on_card
    try:
        yield
    finally:
        DO.ref.decode_attention_ref = saved


def decode_plain(q, k, v, lengths):
    """The plain decode version on the card, in the (B, H, ...) layout →
    the partial triple."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    o, m, l = decode_attention_ref(
        q.reshape(B * Hkv, Hq // Hkv, D), k.reshape(B * Hkv, S, D),
        v.reshape(B * Hkv, S, D), lengths.repeat_interleave(Hkv))
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def rel_err(got, want) -> float:
    """max |got − want| over max |want|: over a long cache |o| is far
    below 1 (about sqrt(e/S) for standard-normal inputs), so an absolute
    bound would pass a wrong result."""
    return float((got - want).abs().max()) / float(want.abs().max())


def unchecked_combine(o, m, l):
    """Control: the combine with its max-correction e^(m − M) dropped."""
    return (o * l[..., None]).sum(0) / l.sum(0).clamp_min(1e-30)[..., None]


def sharded_decode_check(q, k, v, shards, device, card: str) -> tuple:
    """Phase 16 (a): qwen3-14b's decode at B x S held as DIST_SHARDS
    contiguous sequence shards, each shard's partial from the decode
    kernel, combined by ``combine_partials``, at DIST_LENGTHS; held
    against the unsharded kernel and the plain version, relative to max
    |plain|; three controls that the check must fail (the combine without
    its max-correction, a live shard's partial zeroed, a shard's partial
    missing its last DIST_DROP keys); the shard kernel's and the
    combine's times → (path launches, largest absolute error of a shard's
    kernel partial against its plain version, for the kernels line)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.serve import attention as SA
    B, S, N = DIST_B, DIST_S, DIST_SHARDS
    Sl = S // N
    runs = {}
    with plain_decode_forbidden("the sharded path"):
        DK.reset_launches()             # the sharded path starts here
        for L in DIST_LENGTHS:
            lengths = torch.full((B,), L, dtype=torch.int32, device=device)
            parts = [DO.decode_attention(q, ck, cv,
                                         SA.shard_lengths(lengths, i, Sl))
                     for i, (ck, cv) in enumerate(shards)]
            o, m, l = (torch.stack(t) for t in zip(*parts))
            runs[L] = (DO.combine_partials(o, m, l)[0], o, m, l, lengths)
        torch.cuda.synchronize()
        launches = DK.launches()        # ... and ends here
    if launches != N * len(DIST_LENGTHS):
        raise AssertionError(f"sharded decode: {launches} kernel launches, "
                             f"not {N} a shard and length")
    shard_err = shard_abs = 0.0
    controls = {"no max-correction": 1.0, "a shard zeroed": 1.0,
                f"{DIST_DROP} keys dropped": 1.0}
    for L, (got, o, m, l, lengths) in runs.items():
        whole = DO.decode_attention(q, k, v, lengths)[0]
        plain = decode_plain(q, k, v, lengths)[0]
        e_whole, e_plain = rel_err(got, whole), rel_err(got, plain)
        empty = [i for i in range(N) if i * Sl >= L]
        live = [i for i in range(N) if i not in empty]
        for i in range(N):
            part = SA.shard_lengths(lengths, i, Sl)
            po, pm, pl = decode_plain(q, *shards[i], part)
            if i in empty:
                if not (bool((m[i] == -1e30).all())
                        and bool((l[i] == 0).all())):
                    raise AssertionError(f"shard {i} at length {L} is empty"
                                         f" but weighs in (m, l not "
                                         f"-1e30, 0)")
                continue
            shard_err = max(shard_err, rel_err(o[i], po))
            shard_abs = max(shard_abs, float((o[i] - po).abs().max()))
            if L == S and i == 0:       # control: a block of keys missing
                short = decode_plain(q, *shards[i], part - DIST_DROP)[0]
                controls[f"{DIST_DROP} keys dropped"] = rel_err(short, po)
        zeroed = o.clone()
        zeroed[live[-1]] = 0
        c_zero = rel_err(DO.combine_partials(zeroed, m, l)[0], plain)
        controls["a shard zeroed"] = min(controls["a shard zeroed"], c_zero)
        msg = ""
        if len(live) > 1:               # one live shard needs no correction
            c_max = rel_err(unchecked_combine(o, m, l), plain)
            controls["no max-correction"] = min(
                controls["no max-correction"], c_max)
            msg = f", without max-correction {c_max:.3e}"
        log(f"sharded decode at length {L}: {N} shards of {Sl} "
            f"(empty {empty}), max |plain| {float(plain.abs().max()):.4f}; "
            f"relative to it: sharded - unsharded kernel {e_whole:.3e}, "
            f"sharded - plain {e_plain:.3e} (bound {DIST_TOL}); controls: "
            f"shard {live[-1]} zeroed {c_zero:.3e}{msg}")
        if not (e_whole < DIST_TOL and e_plain < DIST_TOL):
            raise AssertionError(f"sharded decode at length {L} off by "
                                 f"{max(e_whole, e_plain):.3e} of max "
                                 f"|plain|")
    log(f"a shard's kernel partial off its plain version by at most "
        f"{shard_err:.3e} of its max |plain| (bound {DIST_TOL}; absolute "
        f"{shard_abs:.3e}); controls "
        f"at their closest: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in controls.items()))
    if not shard_err < DIST_TOL:
        raise AssertionError(f"a shard's kernel partial is {shard_err:.3e} "
                             f"of max |plain| off its plain version")
    passed = [k for k, v in controls.items() if not v >= DIST_TOL]
    if passed:
        raise AssertionError(f"the {DIST_TOL} bound passes wrong results: "
                             f"{passed}")
    Hkv, D = k.shape[1], k.shape[3]
    G = q.shape[1] // Hkv
    qg = q.reshape(B * Hkv, G, D)
    ck, cv = (t.reshape(B * Hkv, Sl, D) for t in shards[0])
    lg = torch.full((B * Hkv,), Sl, dtype=torch.int32, device=device)
    kg, vg = k.reshape(B * Hkv, S, D), v.reshape(B * Hkv, S, D)
    lw = torch.full((B * Hkv,), S, dtype=torch.int32, device=device)
    _, o, m, l, _ = runs[S]
    cold, warm = queued_numbers({
        "shard": lambda: DK.decode_attention_cuda(qg, ck, cv, lg),
        "combine": lambda: DO.combine_partials(o, m, l),
        "unsharded": lambda: DK.decode_attention_cuda(qg, kg, vg, lw)}, 50)
    log(f"sharded decode times on {card} (CUDA events, L2 flushed before "
        f"each call): one shard's kernel ({B} x {Sl} keys) "
        f"{cold['shard'] * 1e3:.3f} us (back to back "
        f"{warm['shard'] * 1e3:.3f} us), the combine of {N} partials "
        f"{cold['combine'] * 1e3:.3f} us ({warm['combine'] * 1e3:.3f} us), "
        f"{N} shards + combine {(N * cold['shard'] + cold['combine']) * 1e3:.3f}"
        f" us against the unsharded kernel {cold['unsharded'] * 1e3:.3f} us "
        f"({warm['unsharded'] * 1e3:.3f} us)")
    return launches, shard_abs


def nccl_check(q, k, v, device, work: str) -> int:
    """Phase 16 (b): a 1-rank NCCL group (``file://`` rendezvous):
    ``flash_decode_sharded`` against the unsharded kernel, and
    ``compressed_psum`` with error feedback over qwen3-14b's tree at full
    width and DIST_LAYERS layers for DIST_STEPS steps → the path's decode
    launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.models import api
    from repro_torch.serve.attention import flash_decode_sharded
    from repro_torch.train import compression as TC
    log("phase 16 (b): a 1-rank NCCL group exercises the NCCL calls "
        "(all_reduce MAX and SUM on the card), not communication")
    for var, val in (("NCCL_SOCKET_IFNAME", "lo"), ("NCCL_IB_DISABLE", "1")):
        os.environ.setdefault(var, val)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "rendezvous"), rank=0, world_size=1)
    try:
        decode = flash_decode_sharded(None)
        outs = {}
        with plain_decode_forbidden("the NCCL path"):
            DK.reset_launches()         # the NCCL decode path starts here
            for L in DIST_LENGTHS:
                lengths = torch.full((DIST_B,), L, dtype=torch.int32,
                                     device=device)
                outs[L] = (decode(q, k, v, lengths), lengths)
            torch.cuda.synchronize()
            launches = DK.launches()    # ... and ends here
        if launches != len(DIST_LENGTHS):
            raise AssertionError(f"NCCL decode: {launches} launches")
        errs = [rel_err(got, DO.decode_attention(q, k, v, lengths)[0])
                for got, lengths in outs.values()]
        log(f"NCCL flash_decode_sharded (1 rank) at lengths {DIST_LENGTHS}:"
            f" |result - unsharded kernel| at most {max(errs):.3e} of max "
            f"|kernel| (bound {DIST_TOL})")
        if not max(errs) < DIST_TOL:
            raise AssertionError(f"NCCL decode off by {max(errs):.3e}")

        cfg = get_config(LLM_ARCH).scaled(n_layers=DIST_LAYERS)
        log(f"reduced: the compressed tree is {cfg.name} at {DIST_LAYERS} "
            f"of its 40 layers (full width; one card's memory)")
        gen = torch.Generator(device=device).manual_seed(16)
        grads = {}
        for path, shape in leaf_shapes(api.param_specs(cfg)):
            grads[path] = torch.randn(shape, generator=gen, device=device)
        n = sum(g.numel() for g in grads.values())
        err = TC.init_error_state(grads)
        acc = {p: torch.zeros_like(g) for p, g in grads.items()}
        worst_q = 0.0
        t0 = time.perf_counter()
        for step in range(DIST_STEPS):
            mean, err = TC.compressed_psum(grads, err)
            for p in acc:
                acc[p] += mean[p]
            if step == 0:               # err is the int8 error of g itself
                for p, g in grads.items():
                    bound = float(g.abs().max()) / 127.0
                    worst_q = max(worst_q, float(err[p].abs().max()) / bound)
            del mean
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not worst_q <= 1.0:
            raise AssertionError(f"int8 error {worst_q:.4f} of scale/127")
        rel = {p: float((acc[p] / DIST_STEPS - g).norm() / g.norm())
               for p, g in grads.items()}
        worst = max(rel, key=rel.get)
        log(f"compressed_psum over {len(grads)} leaves ({n} elements) x "
            f"{DIST_STEPS} steps: {wall:.3f} s; the int8 error of a leaf at "
            f"most {worst_q:.4f} of its scale/127; error feedback: the mean's"
            f" relative error at most {rel[worst]:.3e} ({worst}; bound "
            f"{DIST_EF_TOL})")
        if not rel[worst] < DIST_EF_TOL:
            raise AssertionError(f"error feedback: {worst} off by "
                                 f"{rel[worst]:.3e}")
    finally:
        dist.destroy_process_group()
    return launches


def leaf_shapes(tree, prefix=""):
    """(path, shape) of every TensorSpec leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


def dist_phase(args, device, card: str) -> tuple:
    """Phase 16: the multi-device slice on one card, the plain decode
    version forbidden on its paths → (decode launches of the paths,
    largest absolute error of a shard's kernel partial)."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(LLM_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S, N = DIST_B, DIST_S, DIST_SHARDS
    gen = torch.Generator(device=device).manual_seed(args.seed + 16)
    bf = torch.bfloat16
    q = torch.randn((B, Hq, D), generator=gen, device=device).to(bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=device).to(bf)
    Sl = S // N
    # each shard its own contiguous tensor, as a rank holds it
    shards = [(k[:, :, i * Sl:(i + 1) * Sl].contiguous(),
               v[:, :, i * Sl:(i + 1) * Sl].contiguous()) for i in range(N)]
    log(f"phase 16: sequence-sharded decode at {LLM_ARCH}'s width ({Hq}/"
        f"{Hkv} heads of {D}, bf16), B={B}, cache {S} in {N} shards")

    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        a_launches, shard_err = sharded_decode_check(q, k, v, shards,
                                                     device, card)
        b_launches = nccl_check(q, k, v, device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"multi-device path: {a_launches + b_launches} decode launches "
        f"({a_launches} sharded, {b_launches} through NCCL); no plain "
        f"decode ran")
    return a_launches + b_launches, shard_err


# ---------------------------------------------------------------------------
# phase 17: the meta-device dry run against the card
# ---------------------------------------------------------------------------
def dry_vs_card(what: str, rec: dict, base: int, before: int, rise: int,
                card: str) -> None:
    """Log a dry-run record's bytes beside the card's; fail past DRY_TOL:
    ``argument_bytes`` against the bytes the step's arguments made live
    (``before`` less ``base``, what was live before they were made),
    ``temp_bytes`` against the rise of ``max_memory_allocated`` over
    ``before``."""
    arg, temp = rec["memory"]["argument_bytes"], rec["memory"]["temp_bytes"]
    live = before - base
    ea, et = abs(arg - live) / live, abs(temp - rise) / rise
    log(f"dry run vs {card}, {what}: argument_bytes {arg} predicted, "
        f"{live} B live for the step's arguments ({before} B in all, "
        f"{base} B before they were made; rel err {ea:.4f}); temp_bytes "
        f"{temp} predicted, the peak rose {rise} B above them (rel err "
        f"{et:.4f}); limit {DRY_TOL}")
    if not (ea <= DRY_TOL and et <= DRY_TOL):
        raise AssertionError(f"dry run of {what}: predicted bytes more than "
                             f"{DRY_TOL} off the card's")


def dry_record_line(rec: dict) -> str:
    m, c = rec["memory"], rec["collectives"]
    return (f"args {m['argument_bytes']} B, temp {m['temp_bytes']} B, out "
            f"{m['output_bytes']} B a device; dot FLOPs {rec['dot_flops']:.6e}"
            f", HBM traffic {rec['hbm_traffic_bytes']:.6e} B (unfused "
            f"{rec['unfused_traffic_bytes']:.6e}); collectives "
            f"{c['total']:.6e} B in {c['count']} ({', '.join(f'{k} {c[k]:.4e}' for k in c if k not in ('total', 'count') and c[k])}); "
            f"{rec['replica']['n_ops']} ops and "
            f"{rec['replica']['kernel_launches']} kernel launches traced "
            f"in {rec['trace_s']} s")


def dryrun_phase(args, device, card: str) -> None:
    """Phase 17: the dry run (``repro_torch.launch.dryrun``) traces on
    ``meta``, on a 1x1 mesh, phase 14's training step (qwen3-14b at
    TRAIN_LAYERS, TRAIN_BATCH x TRAIN_SEQ, launch.train's TrainConfig) and
    phase 11's prefill (LLM_LAYERS, 1 x 4096) and decode (ECHO_BATCH over
    a cache of ECHO_LEN); one such training step and one such prefill run
    on the card after ``reset_peak_memory_stats``, and the predicted
    argument and temp bytes must be within DRY_TOL of the card's; the
    counted training dot FLOPs must reach the model FLOPs of
    :func:`train_model_flops`; then the DRY_ARCH row at both production
    meshes (the CLI a user runs, on this host's CPU) must give 6 ok and 2
    skipped records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import api
    from repro_torch.models.api import InputShape
    from repro_torch.serve import make_prefill_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step

    one = MeshShape((1, 1), ("data", "model"))
    tcfg = TrainConfig()                # launch.train's, microbatches 1
    tr_cfg = get_config(LLM_ARCH).scaled(n_layers=TRAIN_LAYERS)
    sv_cfg = get_config(LLM_ARCH).scaled(n_layers=LLM_LAYERS)
    pB, pS = PREFILLS[0]
    cells = {"train": (tr_cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                          "train")),
             "prefill": (sv_cfg, InputShape("prefill", pS, pB, "prefill")),
             "decode": (sv_cfg, InputShape("decode", ECHO_LEN, ECHO_BATCH,
                                           "decode"))}
    recs = {}
    for name, (cfg, shape) in cells.items():
        recs[name] = dryrun.dry_run(cfg, shape, one,
                                    tcfg if name == "train" else None)
        log(f"dry run of {cfg.name} at {cfg.n_layers} layers, {name} "
            f"{shape.global_batch} x {shape.seq_len}, 1x1 mesh, on meta: "
            f"{dry_record_line(recs[name])}")

    gen = torch.Generator(device=device).manual_seed(args.seed + 17)
    rng = np.random.default_rng(args.seed + 17)

    def tokens(cfg, B, S):
        return torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(
            np.int32)).to(device)

    # one training step on the card
    gc.collect()
    base = torch.cuda.memory_allocated(device)
    params = api.init_params(tr_cfg, gen, device)
    params.requires_grad_()
    opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
    batch = {"tokens": tokens(tr_cfg, TRAIN_BATCH, TRAIN_SEQ),
             "labels": tokens(tr_cfg, TRAIN_BATCH, TRAIN_SEQ)}
    step = make_train_step(tr_cfg, tcfg)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)     # in place
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated(device) - before
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"the measured training step's loss {loss}")
    log(f"one training step of {tr_cfg.name} at {TRAIN_LAYERS} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} on {card}: wall {wall:.3f} s (a first"
        f" step), loss {loss:.4f}")
    dry_vs_card(f"the training step ({TRAIN_LAYERS} layers, {TRAIN_BATCH} "
                f"x {TRAIN_SEQ})", recs["train"], base, before, rise, card)
    model, n_mm = train_model_flops(tr_cfg, TRAIN_BATCH, TRAIN_SEQ)
    counted = recs["train"]["dot_flops"]
    log(f"dry run's training dot FLOPs {counted:.6e} against the model "
        f"FLOPs {model:.6e} (6 N tokens, N = {n_mm}, + attention's): ratio "
        f"{counted / model:.4f} (remat recomputes the forward; the "
        f"attention backward's products count whole kv blocks)")
    if counted < model:
        raise AssertionError("the dry run counts fewer training FLOPs than "
                             "the model's")
    del params, opt, batch, step, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # one prefill on the card
    base = torch.cuda.memory_allocated(device)
    params = api.init_params(sv_cfg, gen, device)
    toks = {"tokens": tokens(sv_cfg, pB, pS)}
    prefill = make_prefill_step(sv_cfg)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    logits = prefill(params, toks)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(device) - before
    if not bool(torch.isfinite(logits.float()[:, :sv_cfg.vocab]).all()):
        raise AssertionError("the measured prefill's logits are not finite")
    dry_vs_card(f"the prefill ({LLM_LAYERS} layers, {pB} x {pS})",
                recs["prefill"], base, before, rise, card)
    del params, toks, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the production row, traced on this host's CPU with the card hidden
    work = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    try:
        out = os.path.join(work, "dryrun.jsonl")
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                   CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRY_ARCH, "--mesh", "both", "--out", out], cwd=HERE, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"the dry run's {DRY_ARCH} row failed "
                                 f"({run.returncode}): "
                                 f"{(run.stdout + run.stderr)[-3000:]}")
        with open(out) as f:
            rows = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    status = sorted(r["status"] for r in rows)
    for r in rows:
        if r["status"] == "ok":
            log(f"dry run {r['arch']} {r['shape']} {r['mesh']} "
                f"({r['n_devices']} devices): {dry_record_line(r)}")
        else:
            log(f"dry run {r['arch']} {r['shape']} {r['mesh']}: "
                f"{r['status']} ({r.get('reason', r.get('error'))})")
    log(f"dry run row {DRY_ARCH} --mesh both on this host's CPU: "
        f"{len(rows)} records ({status.count('ok')} ok, "
        f"{status.count('skipped')} skipped) in {wall:.1f} s")
    if status != ["ok"] * 6 + ["skipped"] * 2:
        raise AssertionError(f"the dry run's {DRY_ARCH} row gave {status}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=DRAWS,
                    help="mixture draws before dedupe for the serving phase "
                         "(cut only to fit a time limit; no less than 110M "
                         "keeps >= 100M keys)")
    ap.add_argument("--tune-draws", type=int, default=TUNE_DRAWS,
                    help="mixture draws before dedupe for the tuning phase")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))

    device = torch.device("cuda")
    card = card_info()
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t_start = time.perf_counter()

    def phase(n: int, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        log(f"phase {n} wall: {time.perf_counter() - t0:.1f} s")
        return out

    phase(2, build_all)
    fd_err = phase(3, check_kernel, device, args.seed)
    cs_err = phase(4, check_scores, device, args.seed)
    il_err = phase(5, check_lookup_kernels, device, args.seed)
    attn_err = phase(10, check_attention_kernels, device, args.seed, card)
    fused = phase(6, serve_phase, args, device, card, fd_err)
    scores, tuned = phase(7, tune_phase, args, device, card, cs_err)
    gen1 = phase(8, loop_phase, args, tuned)
    lookups = phase(9, alg1_phase, args, device, card, tuned, gen1, il_err)
    fused["launches"] += phase(13, fleet_phase, args, device, card, tuned)
    del tuned, gen1                     # the card's memory, freed first
    gc.collect()
    torch.cuda.empty_cache()
    # serving builds no autograd graph
    attention = phase(11, torch.no_grad()(llm_phase), args, device, card,
                      attn_err)
    gc.collect()                        # phase 11's model, freed first
    torch.cuda.empty_cache()
    flash = next(e for e in attention if e["name"] == "flash_attention")
    launches, fwd_err = phase(14, train_phase, args, device, card)
    flash["launches"] += launches
    flash["max_abs_err"] = max(flash["max_abs_err"], fwd_err)
    gc.collect()                        # phase 14's model, freed first
    torch.cuda.empty_cache()
    families = phase(15, family_phase, args, device, card)
    for entry in attention:
        entry["launches"] += families[entry["name"]]
    gc.collect()                        # phase 15's models, freed first
    torch.cuda.empty_cache()
    decode = next(e for e in attention if e["name"] == "decode_attention")
    launches, shard_err = phase(16, dist_phase, args, device, card)
    decode["launches"] += launches
    decode["max_abs_err"] = max(decode["max_abs_err"], shard_err)
    gc.collect()
    torch.cuda.empty_cache()
    phase(17, dryrun_phase, args, device, card)
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s (limit "
        f"1200 s, the kernels' build included)")
    print(json.dumps({"kernels": [fused, scores, *lookups, *attention]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
