"""The port's dry run (``repro_torch.launch.dryrun``) and its trace
analysis (``repro_torch.launch.trace_analysis``) against the JAX
package's ``repro.launch.dryrun`` and ``hlo_analysis``.

The JAX dry run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would hold for every later test of a worker, so it runs
only in subprocesses, once per module: one imports it as it stands (the
cell list, the skipped records, ``MICROBATCHES``, every config's
``param_bytes`` and every production cell's per-device argument bytes
from ``NamedSharding(AbstractMesh, spec).shard_shape``), the other with 8
forced host devices (compiled ``argument_size_in_bytes`` on a (2, 4)
mesh, and the HLO dot FLOPs of one device's steps, at SMOKE sizes).  The
cases are exact: bytes and FLOPs are integers on both sides.

Attention is where the two sides differ by design: the JAX package's
models compute it in jnp over kv blocks of 1,024 (``blocked_attention``,
every block whole, masked) and over the whole cache in decode
(``decode_attention_jnp``), while the port's kernels book the live
(query, key) pairs alone.  Each side's attention term is given in closed
form and taken off before the dot FLOPs are compared.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _meta
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.decode_attention import ref as DR
from repro_torch.kernels.flash_attention import ops as AO
from repro_torch.kernels.flash_attention import ref as AR
from repro_torch.launch import dryrun
from repro_torch.launch import trace_analysis as TA
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models import api
from repro_torch.models import ssm
from repro_torch.models.api import InputShape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARCHS = ("qwen3_14b", "llama4_scout_17b_a16e", "zamba2_1p2b",
               "whisper_small")
#: small steps of every kind (global batch 8 on a (2, 4) mesh)
SMALL = {"train": InputShape("train_s", 32, 8, "train"),
         "prefill": InputShape("prefill_s", 32, 8, "prefill"),
         "decode": InputShape("decode_s", 32, 8, "decode")}
MESH_2x4 = MeshShape((2, 4), ("data", "model"))
ONE = MeshShape((1, 1), ("data", "model"))
BLOCK_K = 1024                       # the JAX package's blocked_attention

ALL_CELLS = r"""
import json, math, sys
import repro.launch.dryrun as D                 # forces 512 host devices
import jax
from jax.sharding import AbstractMesh, NamedSharding
from repro.configs import ARCHS, get_config
from repro.models import api

out = {"cells": [], "skipped": {}, "microbatches": D.MICROBATCHES,
       "param_bytes": {}, "argument_bytes": {}}
meshes = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
for arch in ARCHS:
    cfg = get_config(arch)
    out["param_bytes"][arch] = D._tree_bytes(api.param_specs(cfg))
    for shape in api.SHAPES:
        for mp in (False, True):
            key = "|".join((cfg.name, shape, "2x16x16" if mp else "16x16"))
            out["cells"].append(key)
            if not api.shape_supported(cfg, api.SHAPES[shape]):
                out["skipped"][key] = D.run_cell(arch, shape, mp)
                continue
            _, args, shardings, _ = D.build_cell(cfg, api.SHAPES[shape])
            specs = jax.tree.leaves(args)
            shards = jax.tree.leaves(shardings(meshes[mp]))
            assert len(specs) == len(shards)
            out["argument_bytes"][key] = sum(
                math.prod(NamedSharding(sh.mesh, sh.spec).shard_shape(
                    s.shape)) * s.dtype.itemsize
                for s, sh in zip(specs, shards))
json.dump(out, open(sys.argv[1], "w"))
"""

SMOKE_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
assert len(jax.devices()) == 8             # before the dry run's import
import repro.launch.dryrun as D
from jax.sharding import Mesh
from repro.configs import get_config
from repro.dist.sharding import set_activation_mesh
from repro.launch import hlo_analysis
from repro.models.api import InputShape

ARCHS = sys.argv[2].split(",")
SMALL = {"train": InputShape("train_s", 32, 8, "train"),
         "prefill": InputShape("prefill_s", 32, 8, "prefill"),
         "decode": InputShape("decode_s", 32, 8, "decode")}
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {"argument_bytes": {}, "dot_flops": {}}
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    for kind, shape in SMALL.items():
        fn, args, shardings, donate = D.build_cell(cfg, shape)
        set_activation_mesh(mesh)
        with mesh:
            c = jax.jit(fn, in_shardings=shardings(mesh),
                        donate_argnums=donate).lower(*args).compile()
        out["argument_bytes"][arch + "|" + kind] = \
            c.memory_analysis().argument_size_in_bytes
        set_activation_mesh(None)
        one = jax.jit(fn).lower(*args).compile()
        out["dot_flops"][arch + "|" + kind] = \
            hlo_analysis.analyze(one.as_text())["dot_flops"]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Both JAX subprocesses, run at once → (all cells, SMOKE cells)."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    runs = [(ALL_CELLS, str(d / "all.json"), []),
            (SMOKE_CELLS, str(d / "smoke.json"), [",".join(SMOKE_ARCHS)])]
    procs = [subprocess.Popen([sys.executable, "-c", script, path, *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
             for script, path, extra in runs]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return tuple(json.load(open(path)) for _, path, _ in runs)


# ---------------------------------------------------------------------------
# the cells, the skipped records and the bytes against the JAX package
# ---------------------------------------------------------------------------
def test_cells_skips_and_microbatches_equal_the_jax_packages(jax_side):
    ref, _ = jax_side
    cells = ["|".join((get_config(a).name, s, dryrun.mesh_name(mp)))
             for a, s, mp in dryrun.cells(ARCHS, list(api.SHAPES),
                                          [False, True])]
    assert cells == ref["cells"]
    assert dryrun.MICROBATCHES == ref["microbatches"]
    skipped = 0
    for key in cells:
        arch, shape, mesh = key.split("|")
        if key in ref["skipped"]:
            rec = dryrun.run_cell(arch, shape, mesh == "2x16x16")
            assert rec == ref["skipped"][key]
            skipped += 1
    assert skipped == 16              # long_500k: eight archs, two meshes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_equal_the_jax_packages(jax_side, arch):
    assert dryrun._tree_bytes(api.param_specs(get_config(arch))) \
        == jax_side[0]["param_bytes"][arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_jax_shard_shapes(jax_side, arch):
    """Every supported production cell of ``arch`` at 16×16 and
    2×16×16."""
    cfg, n = get_config(arch), 0
    for shape in api.SHAPES.values():
        if not api.shape_supported(cfg, shape):
            continue
        for mp in (False, True):
            mesh = production_shape(multi_pod=mp)
            cell = dryrun.build_cell(cfg, shape, mesh)
            key = "|".join((cfg.name, shape.name, dryrun.mesh_name(mp)))
            assert dryrun.sharded_bytes(cell.specs, cell.shards, mesh) \
                == jax_side[0]["argument_bytes"][key], key
            n += 1
    assert n >= 6


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_argument_bytes_equal_the_compiled_memory_analysis(jax_side, arch,
                                                           kind):
    """XLA's compiled ``argument_size_in_bytes`` on a (2, 4) mesh of 8
    host devices equals the port's per-device argument bytes: XLA pads
    no buffer of these steps.  One difference is named: ``jax.jit`` drops
    the arguments a step never reads, and whisper's decode reads neither
    the encoder's leaves (``pos_enc``, ``enc_blocks``, ``enc_final_norm``:
    the encoder's K/V come in the state) nor the decoder's cross-attention
    projections ``xk`` and ``xv``; the port counts every argument, as
    every one is resident."""
    cfg = get_config(arch, smoke=True)
    cell = dryrun.build_cell(cfg, SMALL[kind], MESH_2x4)
    got = dryrun.sharded_bytes(cell.specs, cell.shards, MESH_2x4)
    if arch == "whisper_small" and kind == "decode":
        ps, sh = cell.specs[0], cell.shards[0]
        for k in ("pos_enc", "enc_blocks", "enc_final_norm"):
            got -= dryrun.sharded_bytes(ps[k], sh[k], MESH_2x4)
        for k in ("xk", "xv"):
            got -= dryrun.sharded_bytes(ps["dec_blocks"][k],
                                        sh["dec_blocks"][k], MESH_2x4)
    assert got == jax_side[1]["argument_bytes"][f"{arch}|{kind}"]


# ---------------------------------------------------------------------------
# dot FLOPs against the JAX package's HLO analysis
# ---------------------------------------------------------------------------
def _self_attention_layers(cfg) -> int:
    """Causal self-attention calls a step makes: every layer of the
    transformer families and of whisper's decoder, each application of
    zamba2's shared block."""
    if cfg.family == "hybrid":
        return ssm.n_shared_applications(cfg)
    return cfg.n_layers


def _attention_terms(cfg, kind, shape):
    """(the port's booked attention FLOPs, the JAX package's jnp
    attention FLOPs) of one step, in closed form."""
    B, S, D, Hq = shape.global_batch, shape.seq_len, cfg.hd, cfg.n_heads
    n_self = _self_attention_layers(cfg)
    port = ref = 0
    if kind == "prefill":
        port += n_self * 4 * D * B * Hq * S * (S + 1) // 2
        ref += n_self * 4 * B * Hq * S * (-(-S // BLOCK_K) * BLOCK_K) * D
    else:                              # one token over the full cache
        port += n_self * 4 * D * B * Hq * S
        ref += n_self * 4 * B * Hq * S * D
    if cfg.family == "audio":          # the encoder (prefill) and the
        F, Sq = cfg.n_frames, (S if kind == "prefill" else 1)   # cross-
        blocks = -(-F // BLOCK_K) * BLOCK_K                 # attention
        if kind == "prefill":
            port += cfg.encoder_layers * 4 * D * B * Hq * F * F
            ref += cfg.encoder_layers * 4 * B * Hq * F * blocks * D
        port += cfg.n_layers * 4 * D * B * Hq * Sq * F
        ref += cfg.n_layers * 4 * B * Hq * Sq * blocks * D
    return port, ref


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_dot_flops_less_attention_equal_the_hlo_analysis(jax_side, arch,
                                                          kind):
    """One device's prefill and decode: the port's dot FLOPs less its
    booked attention equal the JAX package's HLO dot FLOPs less its jnp
    attention (each in closed form; the booked term is checked too), but
    for two products the port computes and XLA drops as dead code, as no
    serving step returns them:

    · MoE: the load-balancing loss's router product (2·T·d·E a layer,
      T = B·Sq tokens), the router logits computed a second time;
    · zamba2's prefill: the chunked scan's state contribution of the
      last chunk (2·B·H·C·N·P a mamba layer, C = min(32, S)), which
      feeds only the final state.
    """
    cfg = get_config(arch, smoke=True)
    shape = SMALL[kind]
    rec = dryrun.dry_run(cfg, shape, ONE)
    port_attn, ref_attn = _attention_terms(cfg, kind, shape)
    assert rec["replica"]["kernel_flops"] == port_attn
    B, S = shape.global_batch, shape.seq_len
    dead = 0
    if cfg.n_experts:
        T = B * (S if kind == "prefill" else 1)
        dead += cfg.n_layers * 2 * T * cfg.d_model * cfg.n_experts
    if cfg.family == "hybrid" and kind == "prefill":
        _, H, N = ssm._dims(cfg)
        dead += cfg.n_layers * 2 * B * H * min(32, S) * N * ssm.HEAD
    assert rec["dot_flops"] - port_attn - dead \
        == jax_side[1]["dot_flops"][f"{arch}|{kind}"] - ref_attn


def test_train_dot_flops_against_the_hlo_analysis(jax_side):
    """qwen3's SMOKE train step (remat, two microbatches): the port's
    dots less its attention against the JAX package's less its blocked
    attention are equal.  The port's attention: the flash kernel's
    forward, run twice (the forward and the remat recompute), and its
    backward in PyTorch ops over kv blocks of up to 1,024 keys (here one
    block of S): the scores and P·V recomputed, then the scores again,
    dV, dP, dQ and dK, seven products of 2·B·Hq·S·S·D.  The JAX
    package's: the two einsums of each whole 1,024-key block in the
    forward and the remat recompute and their two gradients each in the
    backward, eight products of 2·B·Hq·S·1024·D."""
    cfg = get_config("qwen3_14b", smoke=True)
    shape = SMALL["train"]
    rec = dryrun.dry_run(cfg, shape, ONE)
    B, S, D, Hq, L = (shape.global_batch, shape.seq_len, cfg.hd,
                      cfg.n_heads, cfg.n_layers)
    pairs = S * (S + 1) // 2
    assert rec["replica"]["kernel_flops"] == 2 * L * 4 * D * B * Hq * pairs
    port_bwd = L * 7 * 2 * B * Hq * S * S * D
    ref_attn = L * 8 * 2 * B * Hq * S * BLOCK_K * D
    port = rec["dot_flops"] - rec["replica"]["kernel_flops"] - port_bwd
    assert port == jax_side[1]["dot_flops"]["qwen3_14b|train"] - ref_attn


# ---------------------------------------------------------------------------
# the trace analyser on the JAX package's HLO-analysis cases
# ---------------------------------------------------------------------------
def _tanh_chain(n, nested=1, size=128):
    c = torch.empty(size, size, device="meta")
    w = torch.empty(size, size, device="meta")

    def f(c, w):
        for _ in range(n):
            for _ in range(nested):
                c = torch.tanh(c @ w)
        return c
    return TA.trace(f, c, w)[1]


@pytest.mark.parametrize("n", [1, 4, 16])
def test_chain_flops_exact(n):
    assert TA.analyze(_tanh_chain(n))["dot_flops"] == 2 * 128 ** 3 * n


def test_nested_chain_flops_exact():
    """The reference's 4 × 3 nested scan: every step is its own op."""
    assert TA.analyze(_tanh_chain(4, 3))["dot_flops"] == 2 * 128 ** 3 * 12


def test_top_dots_ordering_and_fields():
    tr = _tanh_chain(8)
    c = torch.empty(256, 128, device="meta")
    w = torch.empty(128, 128, device="meta")
    tr.ops += TA.trace(lambda a, b: a @ b, c, w)[1].ops
    dots = TA.top_dots(tr, 5)
    assert dots[0]["flops"] == 2 * 256 * 128 * 128 \
        and dots[0]["result"] == [256, 128] and dots[0]["contract"] == 128
    assert dots[1]["flops"] == 2 * 128 ** 3
    assert all(d["mult"] == 1 for d in dots)
    assert all(a["flops"] >= b["flops"] for a, b in zip(dots, dots[1:]))
    assert len(TA.top_dots(tr, 100)) == 9


def test_slice_write_traffic_counts_the_update_only():
    """The reference's dynamic-update-slice case: 2 × the update bytes,
    not the 4 MB target; an index_put_ alike."""
    cache = torch.empty(1024, 1024, device="meta")
    upd = torch.empty(1, 1024, device="meta")

    def f(cache, upd):
        cache[5:6] = upd
        cache.index_put_((torch.zeros(1, dtype=torch.long,
                                      device="meta"),), upd[0])
        return cache
    a = TA.analyze(TA.trace(f, cache, upd)[1])
    assert a["dus_traffic_bytes"] == 2 * (2 * 1024 * 4)
    assert a["hbm_traffic_bytes"] == a["dus_traffic_bytes"]
    assert a["collective_bytes"]["total"] == 0


def test_collective_rule_on_a_two_layer_toy_counted_by_hand():
    """x (8, 16) → x @ w1 (16, 32) → @ w2 (32, 16) → sum, its gradient,
    at a (2, 4) mesh: w1 sharded over "model" on its output dim (32) and
    w2 on its contraction dim (32): forward all-gather of x@w1's share
    and all-reduce of x@w1@w2; backward g2 @ w2ᵀ (w2's dim 0 is now an
    output dim: all-gather) — the weight gradients read no weight."""
    mesh = MeshShape((2, 4), ("data", "model"))
    x = torch.empty(8, 16, device="meta")
    w1 = torch.empty(16, 32, device="meta", requires_grad=True)
    w2 = torch.empty(32, 16, device="meta", requires_grad=True)

    def step(x, w1, w2):
        y = (x @ w1 @ w2).sum()
        return torch.autograd.grad(y, [w1, w2])
    _, tr = TA.trace(step, x, w1, w2, leaves={"w1": w1, "w2": w2})
    grads = {0: (16 * 32 // 4 * 4, 16 * 32 // 4 // 2 * 4, True),
             1: (32 * 16 // 4 * 4, 32 * 16 // 4 * 4, False)}
    rules = TA.CollectiveRules(mesh.shape, {"w1": (None, "model"),
                                            "w2": ("model", None)}, grads)
    c = TA.analyze(tr, rules)["collective_bytes"]
    f32 = 4
    assert c["all-gather"] == 8 * 32 * f32 / 4 + 8 * 32 * f32 / 4 \
        + 16 * 32 // 4 // 2 * f32
    assert c["all-reduce"] == 8 * 16 * f32 + 32 * 16 // 4 * f32
    assert c["reduce-scatter"] == 16 * 32 // 4 * f32
    assert c["count"] == 3 + 3
    assert c["total"] == c["all-gather"] + c["all-reduce"] \
        + c["reduce-scatter"]


def test_peak_bytes_follow_the_storages():
    def f(x):
        a = x.exp()                    # 4 KiB
        b = a * 2                      # 4 KiB: 8 live, the peak
        del a
        return b.sum()                 # 4 B while b lives
    x = torch.empty(32, 32, device="meta")
    _, tr = TA.trace(f, x)
    assert tr.peak_bytes == 2 * 4096
    assert tr.end_bytes == 4           # the result alone


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------
def _forbid(monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on meta")
    monkeypatch.setattr(AR, "attention_ref", plain)
    monkeypatch.setattr(AO.ref, "attention_ref", plain)
    monkeypatch.setattr(DR, "decode_attention_ref", plain)
    monkeypatch.setattr(DO.ref, "decode_attention_ref", plain)


@pytest.mark.parametrize("case", [
    dict(Sq=37, Skv=37, causal=True, window=None),
    dict(Sq=5, Skv=40, causal=True, window=16),
    dict(Sq=40, Skv=9, causal=False, window=None),
    dict(Sq=20, Skv=30, causal=False, window=7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branch(monkeypatch, case, dtype):
    B, Hq, Hkv, D = 2, 4, 2, 32
    rng = np.random.default_rng(0)
    mk = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype))
    q, k, v = (mk(B, Hq, case["Sq"], D), mk(B, Hkv, case["Skv"], D),
               mk(B, Hkv, case["Skv"], D))
    opts = dict(causal=case["causal"], window=case["window"])
    want = AO.flash_attention(q, k, v, **opts)
    mask_pairs = int(sum(
        1 for i in range(case["Sq"]) for j in range(case["Skv"])
        if (not case["causal"] or j <= case["Skv"] - case["Sq"] + i)
        and (case["window"] is None
             or j > case["Skv"] - case["Sq"] + i - case["window"])))
    _forbid(monkeypatch)
    booked = []
    with _meta.recording(booked):
        got = AO.flash_attention(*(t.to("meta") for t in (q, k, v)), **opts)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.device.type == "meta"
    assert len(booked) == 1 and booked[0].kernel == "flash_attention"
    assert booked[0].flops == 4 * D * B * Hq * mask_pairs
    item = q.element_size()
    assert booked[0].bytes == 2 * q.numel() * item \
        + (k.numel() + v.numel()) * item


@pytest.mark.parametrize("Sq", [1, 3, 17])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_meta_branch(monkeypatch, Sq, window, dtype):
    B, Hq, Hkv, S, D = 2, 8, 2, 20, 32
    rng = np.random.default_rng(1)
    mk = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype))
    q, k, v = mk(B, Hq, Sq, D), mk(B, Hkv, S, D), mk(B, Hkv, S, D)
    lens = torch.full((B,), S, dtype=torch.int32)
    want = DO.decode_attention(q, k, v, lens, window=window)
    _forbid(monkeypatch)
    booked = []
    with _meta.recording(booked):
        got = DO.decode_attention(*(t.to("meta") for t in (q, k, v, lens)),
                                  window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    rows, keys = Hq // Hkv * Sq, B * Hkv * (S if window is None else window)
    assert len(booked) == 1 and booked[0].kernel == "decode_attention"
    assert booked[0].flops == 4 * rows * D * keys
    assert booked[0].bytes == 2 * keys * D * k.element_size() \
        + q.numel() * q.element_size() + B * Hkv * rows * (D + 2) * 4


def test_a_step_traces_on_meta_with_the_plain_versions_forbidden(
        monkeypatch):
    """SMOKE qwen3's prefill and decode run on meta through the two meta
    branches alone."""
    _forbid(monkeypatch)
    cfg = get_config("qwen3_14b", smoke=True)
    for kind in ("prefill", "decode"):
        rec = dryrun.dry_run(cfg, SMALL[kind], ONE)
        assert rec["replica"]["kernel_launches"] == cfg.n_layers


# ---------------------------------------------------------------------------
# full width and the CLI
# ---------------------------------------------------------------------------
def test_qwen3_full_width_cells():
    """qwen3-14b's prefill and decode at 16×16: the records' keys, the
    per-device split of the replica and the kernels booked a layer."""
    cfg, mesh = get_config("qwen3_14b"), production_shape()
    for name in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen3_14b", name, False)
        assert rec["status"] == "ok" and rec["n_devices"] == 256
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "generated_code_bytes"}
        assert rec["memory"]["generated_code_bytes"] is None
        rep = rec["replica"]
        assert rec["dot_flops"] == rep["dot_flops"] / 16
        assert rec["memory"]["temp_bytes"] == rep["temp_bytes"] // 16
        assert rep["kernel_launches"] == cfg.n_layers
        assert rec["memory"]["argument_bytes"] == dryrun.sharded_bytes(
            *(lambda c: (c.specs, c.shards))(dryrun.build_cell(
                cfg, api.SHAPES[name], mesh)), mesh)
        assert rec["collectives"]["total"] > 0
    assert rec["memory"]["argument_bytes"] > 40e9     # the 32k caches


def test_cli_writes_both_meshes_and_a_rerun_skips_them(tmp_path):
    out = tmp_path / "d.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen3_14b", "--shape", "prefill_32k", "--mesh", "both",
           "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    first = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in recs] == \
        [("16x16", "ok"), ("2x16x16", "ok")]
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    assert again.stdout.count("[skip-cached]") == 2
    assert len(out.read_text().splitlines()) == 2
