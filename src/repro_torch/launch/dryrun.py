"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell.

The JAX package's ``repro.launch.dryrun`` forces 512 XLA host devices,
lowers and compiles each step onto the production mesh from
``ShapeDtypeStruct`` inputs, and records XLA's memory and cost analyses
and the collectives parsed from the partitioned HLO.  PyTorch has no
compiler that partitions a step, and a mesh of processes would need 512
of them, so this dry run takes another way: it runs the port's own step
on the ``meta`` device, where tensors carry shapes and types and no
values, and records what :mod:`repro_torch.launch.trace_analysis` reads
off the trace.  It needs no XLA flag, no process group and no card, and
runs on any CPU.

What is traced: one data-parallel replica.  Its batch is the global
batch divided by the data-parallel extent where ``batch_sharding`` shards
it, its weights are whole, and no activation mesh is installed.  Per
device, a record gives:

  · ``memory.argument_bytes`` and ``memory.output_bytes`` exactly: the
    sum of each argument (result) leaf's shard shape under the sharding
    rules (``dist.sharding``) on the production mesh;
  · FLOPs, traffic and ``memory.temp_bytes`` as the replica's divided by
    the model-axis size, an ideal split; the ``replica`` block keeps the
    undivided numbers.  ``temp_bytes`` is the most bytes the step's own
    allocations hold at once (its results included), as a card's
    allocator would see them above the arguments;
  · ``collectives`` from the rules (``trace_analysis.CollectiveRules``);
  · ``cost``: ``flops`` the dot FLOPs and ``bytes accessed`` the unfused
    traffic, per device (XLA's cost analysis has no counterpart).

``trace_s`` replaces the reference's ``lower_s`` and ``compile_s``; the
other keys are the reference's.  Decode steps run at the last position
of a full cache (``pos = seq_len − 1``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out d.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.sharding import (batch_sharding, decode_state_shardings,
                                       mesh_shape, param_shardings,
                                       replicated, set_activation_mesh,
                                       tree_map)
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.models.params import TensorSpec
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig, make_train_step

META = torch.device("meta")
SKIP_REASON = ("long-context decode requires sub-quadratic attention "
               "(DESIGN.md §5)")

# grad-accumulation microbatches per arch (train_4k), the JAX package's
MICROBATCHES = {
    "deepseek-coder-33b": 8, "llava-next-34b": 8, "grok-1-314b": 4,
    "gemma2-27b": 4, "qwen3-14b": 2, "glm4-9b": 2,
    "llama4-scout-17b-a16e": 4, "rwkv6-7b": 2, "zamba2-1.2b": 1,
    "whisper-small": 1,
}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _tree_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in _leaves(specs))


def _shard_bytes(spec: TensorSpec, sharding, mesh: MeshShape) -> int:
    """Bytes of one device's shard of ``spec`` under ``sharding``."""
    n = 1
    for dim, entry in zip(spec.shape, tuple(sharding.spec)
                          + (None,) * len(spec.shape)):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n * spec.dtype.itemsize


def sharded_bytes(specs, shardings, mesh: MeshShape) -> int:
    """Σ one device's shard bytes over a spec tree and its shardings."""
    return sum(_shard_bytes(s, sh, mesh) for s, sh in
               zip(_leaves(specs), _leaves(shardings)))


def _meta(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=META), specs)


def _replica(specs, mesh: MeshShape):
    """The batch leaves one data-parallel replica holds: the leading dim
    divided by the data extent where ``batch_sharding`` shards it."""
    def one(s, sh):
        entry = tuple(sh.spec)[0] if len(tuple(sh.spec)) else None
        if entry is None:
            return s
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dp = math.prod(mesh.shape[a] for a in axes)
        return TensorSpec((s.shape[0] // dp, *s.shape[1:]), s.dtype)
    return tree_map(one, specs, batch_sharding(mesh, specs))


def opt_config(cfg) -> AdamWConfig:
    """The reference's optimizer for a cell: grok's moments in bf16."""
    return AdamWConfig(moment_dtype="bfloat16" if cfg.name == "grok-1-314b"
                       else "float32")


def moment_specs(pspecs, ocfg: AdamWConfig):
    dt = getattr(torch, ocfg.moment_dtype)
    return tree_map(lambda s: TensorSpec(tuple(s.shape), dt), pspecs)


def leaf_specs(model, shardings) -> dict:
    """Each parameter's name (as ``named_parameters`` gives it) → its
    spec as the port holds it: a stacked leaf's spec without its layer
    axis."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for path, _, params, stacked in P.leaves(model):
        node = shardings
        for k in path:
            node = node[k]
        spec = tuple(node.spec)
        for p in params:
            out[by_id[id(p)]] = spec[1:] if stacked else spec
    return out


def zero_rules(cfg, pspecs, mesh: MeshShape) -> dict:
    """JAX leaf → (per-device gradient bytes, per-device ZeRO shard
    bytes, whether its moments are data-sharded), for the collective
    rule of a training step."""
    plain = param_shardings(cfg, pspecs, mesh)
    zero = param_shardings(cfg, pspecs, mesh, zero=True)
    out = {}
    for i, (s, a, b) in enumerate(zip(_leaves(pspecs), _leaves(plain),
                                      _leaves(zero))):
        data = any(e not in (None, "model") for e in tuple(b.spec))
        out[i] = (_shard_bytes(s, a, mesh), _shard_bytes(s, b, mesh), data)
    return out


@dataclasses.dataclass
class Cell:
    """One replica's step on ``meta``: ``fn(*args)`` is traced; ``model``
    holds the parameters; ``specs``/``shards`` are the step's global
    arguments and their shardings, ``out``/``out_shards`` its results;
    ``zero`` is the training step's gradient rule (``zero_rules``)."""
    fn: object
    args: tuple
    model: object
    specs: tuple
    shards: tuple
    out: tuple
    out_shards: tuple
    zero: dict | None = None


def build_cell(cfg, shape, mesh: MeshShape,
               tcfg: TrainConfig | None = None) -> Cell:
    """The :class:`Cell` of one replica of ``shape`` on ``mesh``."""
    pspecs = api.param_specs(cfg)
    pshard = param_shardings(cfg, pspecs, mesh)
    bspecs = api.input_specs(cfg, shape)
    bshard = batch_sharding(mesh, bspecs)
    batch = _meta(_replica(bspecs, mesh))
    model = api.empty_params(cfg, META)
    scalar = TensorSpec((), torch.int32)
    logits = {"logits": TensorSpec((shape.global_batch, cfg.padded_vocab),
                                   _logit_dtype(cfg))}
    if shape.kind == "train":
        tcfg = tcfg or TrainConfig(optimizer=opt_config(cfg),
                                   microbatches=MICROBATCHES.get(cfg.name, 1))
        model.requires_grad_()
        mspecs = moment_specs(pspecs, tcfg.optimizer)
        mshard = param_shardings(cfg, mspecs, mesh, zero=True)
        mdt = getattr(torch, tcfg.optimizer.moment_dtype)
        opt = {k: {n: torch.empty(p.shape, dtype=mdt, device=META)
                   for n, p in model.named_parameters()} for k in "mv"}
        opt["step"] = 0
        specs = (pspecs, mspecs, mspecs, scalar)
        shards = (pshard, mshard, mshard, replicated(mesh))
        metrics = (TensorSpec((), torch.float32),) * 2   # loss, grad_norm
        return Cell(make_train_step(cfg, tcfg), (model, opt, batch), model,
                    (*specs, bspecs), (*shards, bshard), (specs, metrics),
                    (shards, (replicated(mesh),) * 2),
                    zero_rules(cfg, pspecs, mesh))
    if shape.kind == "prefill":
        return Cell(make_prefill_step(cfg), (model, batch), model,
                    (pspecs, bspecs), (pshard, bshard), logits,
                    batch_sharding(mesh, logits))
    sspecs = api.decode_state_specs(cfg, shape.global_batch, shape.seq_len)
    sshard = decode_state_shardings(cfg, sspecs, mesh)
    state = _meta(_replica_state(sspecs, sshard, mesh))
    return Cell(make_decode_step(cfg),
                (model, batch, state, shape.seq_len - 1), model,
                (pspecs, bspecs, sspecs, scalar),
                (pshard, bshard, sshard, replicated(mesh)),
                (logits, sspecs), (batch_sharding(mesh, logits), sshard))


def _logit_dtype(cfg) -> torch.dtype:
    return torch.float32 if cfg.final_softcap else cfg.torch_dtype


def _replica_state(specs, shards, mesh: MeshShape):
    """Decode-state leaves (L, B, …) of one replica: the batch axis
    divided where the rules shard it over data (head shards stay whole,
    as the replica's weights do)."""
    def one(s, sh):
        spec = tuple(sh.spec)
        if len(spec) < 2 or spec[1] is None:
            return s
        axes = (spec[1],) if isinstance(spec[1], str) else tuple(spec[1])
        dp = math.prod(mesh.shape[a] for a in axes)
        return TensorSpec((s.shape[0], s.shape[1] // dp, *s.shape[2:]),
                          s.dtype)
    return tree_map(one, specs, shards)


def dry_run(cfg, shape, mesh, tcfg: TrainConfig | None = None) -> dict:
    """Trace one replica of ``shape`` on ``mesh`` (a ``MeshShape`` or a
    device mesh) → the record's numbers (without arch/shape/mesh)."""
    mesh = mesh_shape(mesh)
    set_activation_mesh(None)
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, tcfg)
    names = dict(cell.model.named_parameters())
    _, tr = trace_analysis.trace(cell.fn, *cell.args, leaves=names)
    trace_s = time.perf_counter() - t0
    rules = trace_analysis.CollectiveRules(
        mesh.shape, leaf_specs(cell.model, param_shardings(
            cfg, api.param_specs(cfg), mesh)), cell.zero)
    a = trace_analysis.analyze(tr, rules)
    tp = mesh.shape.get("model", 1)
    replica = {"dot_flops": a["dot_flops"],
               "hbm_traffic_bytes": a["hbm_traffic_bytes"],
               "unfused_traffic_bytes": a["unfused_traffic_bytes"],
               "dus_traffic_bytes": a["dus_traffic_bytes"],
               "temp_bytes": tr.peak_bytes, "n_ops": a["n_ops"],
               "kernel_launches": len(tr.bookings),
               "kernel_flops": sum(b.flops for b in tr.bookings),
               "kernel_bytes": sum(b.bytes for b in tr.bookings)}
    return {
        "status": "ok",
        "n_devices": int(mesh.size),
        "trace_s": round(trace_s, 1),
        "param_bytes": _tree_bytes(api.param_specs(cfg)),
        "dot_flops": a["dot_flops"] / tp,
        "hbm_traffic_bytes": a["hbm_traffic_bytes"] / tp,
        "unfused_traffic_bytes": a["unfused_traffic_bytes"] / tp,
        "collectives": a["collective_bytes"],
        "memory": {
            "argument_bytes": sharded_bytes(cell.specs, cell.shards, mesh),
            "output_bytes": sharded_bytes(cell.out, cell.out_shards, mesh),
            "temp_bytes": tr.peak_bytes // tp,
            "generated_code_bytes": None,
        },
        "cost": {"flops": a["dot_flops"] / tp,
                 "bytes accessed": a["unfused_traffic_bytes"] / tp},
        "replica": replica,
    }


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = api.SHAPES[shape_name]
    rec = {"arch": cfg.name, "shape": shape_name,
           "mesh": mesh_name(multi_pod)}
    if not api.shape_supported(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    rec.update(dry_run(cfg, shape, production_shape(multi_pod=multi_pod)))
    return rec


def cells(archs, shapes, meshes) -> list:
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(api.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    for arch, shape, mp in cells(archs, shapes, meshes):
        cfgname = get_config(arch).name
        key = (cfgname, shape, mesh_name(mp))
        if key in done:
            print(f"[skip-cached] {key}", flush=True)
            continue
        print(f"[cell] {key} ...", flush=True)
        try:
            rec = run_cell(arch, shape, mp)
        except Exception as e:  # record failures — they are bugs to fix
            rec = {"arch": cfgname, "shape": shape, "mesh": mesh_name(mp),
                   "status": "error", "error": repr(e)[:2000]}
        print(json.dumps(rec)[:600], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if rec["status"] == "ok":
            m = rec["memory"]
            print(f"    mem/dev: args={m['argument_bytes']}, "
                  f"temp={m['temp_bytes']}; flops={rec['cost']['flops']}; "
                  f"coll={rec['collectives']['total']}", flush=True)


if __name__ == "__main__":
    main()
