"""Every public function and method of the JAX package exists in the port
with the reference's parameters, in order.

Discovered from the reference's tree: every module under ``src/repro``
(each must exist under ``src/repro_torch``), each public function it
defines, each public class it defines with its public methods, static
and class methods, properties and ``__init__``.  A difference passes only
where the tables below name it with its reason: parameters the port adds
(the device an entry point runs on, the ranking backend, an output
buffer), renamed ones (a ``torch.Generator`` for a JAX key, a model for a
parameter tree, a process group for a mesh axis), the Pallas-only tile
and interpret switches of the kernel ops, the plain versions that carry
the port's name, and a few functions listed one by one.  Anything else
fails, so a public entry point of the reference that the port lacks, or
takes otherwise, shows here first."""
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ROOT = os.path.join(REPO, "src", "repro")
PORT_ROOT = os.path.join(REPO, "src", "repro_torch")

#: parameters the port adds anywhere, with their reason
ADDED = {
    "device": "the port's entry points run on the card unless the caller "
              "names another device (the JAX package has one device)",
    "score_backend": "the tuner's ranking backend is a keyword of the "
                     "port's entry points, never a TuneSpec field",
    "out": "the kernel ops write into a caller's buffer, so the model's "
           "(B, S, H, D) layout needs no copy",
}
#: reference parameter → the port's, anywhere
RENAMED = {
    "rng": ("generator", "a torch.Generator or int seed for a JAX key"),
    "params": ("model", "the port's parameters are an nn.Module"),
    "mesh": ("group", "a torch.distributed process group for a mesh"),
    "axis_name": ("group", "a torch.distributed process group for a "
                           "shard_map axis"),
}
#: parameters of the Pallas kernels' ops that only a TPU kernel has
PALLAS_ONLY = {"interpret", "use_ref", "block_q", "block_k"}
#: the JAX package's jnp/ref plain versions and their port names; their
#: parameters are the port kernels' own
PLAIN_VERSIONS = {
    ("kernels.fused_descent.ref", "fused_descent_jnp"): "fused_descent_torch",
    ("kernels.index_lookup.ref", "step_lookup_ref"): "step_lookup_torch",
    ("kernels.index_lookup.ref", "band_lookup_ref"): "band_lookup_torch",
    ("kernels.index_lookup.ref", "segmented_step_lookup_ref"):
        "segmented_step_lookup_torch",
}
#: one function at a time: (module, qualified name) → (the port's
#: parameters, why); None: not ported as a function, with why
ONE_BY_ONE = {
    ("models.transformer", "decode_attention_jnp"): (
        None, "the port's decode attention is the kernel op "
              "kernels.decode_attention.ops.decode_attention_folded, its "
              "plain version decode_attention_ref"),
    ("models.layers", "rope"): (
        ["x", "tables"], "the rotation tables (rope_tables) are computed "
                         "once a forward, not once a layer"),
    ("kernels.decode_attention.ops", "decode_attention"): (
        ["q", "k", "v", "kv_length", "scale", "window", "softcap"],
        "gemma2 decodes through the kernel with its window and softcap "
        "(ROADMAP F3); no Pallas tile or interpret switch"),
    ("kernels.decode_attention.ref", "decode_attention_ref"): (
        ["q", "k", "v", "kv_length", "scale", "window", "softcap"],
        "the kernel's plain version takes what the kernel takes (F3)"),
    ("kernels.fused_descent.ops", "fused_descent_with_backend"): (
        ["layers", "queries", "backend", "module", "device"],
        "the engine hands over its resident FusedDescent module (the packed "
        "planes on the device) instead of packed numpy planes"),
    ("core.airtune", "TuneStats.__init__"): (
        None, "a dataclass: the reference's fields first, then the device "
              "ranking's est_* counters"),
    ("launch.dryrun", "build_cell"): (
        ["cfg", "shape", "mesh", "tcfg"],
        "one replica of the cell on a named mesh shape (the JAX package "
        "reads the mesh and the training config from the process)"),
    ("kernels.flash_attention.ops", "flash_attention"): (
        ["q", "k", "v", "causal", "window", "softcap", "scale", "q_offset",
         "kv_length", "block_k", "out"],
        "the op also takes blocked_attention's placement of the queries and "
        "row lengths (the Pallas op end-aligns and reads every key); "
        "block_k sets the plain version's kv blocks, the kernel keeps its "
        "own tiles"),
    ("kernels.flash_attention.ref", "attention_ref"): (
        ["q", "k", "v", "causal", "window", "softcap", "q_offset",
         "kv_length", "scale", "block_k"],
        "the plain version takes what the kernel takes: the queries' "
        "offset, and blocked_attention's kv blocks on the CPU"),
    ("models.config", "ModelConfig.jdtype"): (
        None, "the JAX dtype; the port's is ModelConfig.torch_dtype"),
    ("launch.dryrun", "main"): (["argv"], "argv, so tests run it in process"),
    ("launch.serve", "main"): (["argv"], "argv, so tests run it in process"),
    ("launch.train", "main"): (["argv"], "argv, so tests run it in process"),
}


def _modules(root):
    out = []
    for here, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(here, f), root)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return sorted(out)


REF_MODULES = _modules(REF_ROOT)


def _public(mod):
    """(qualified name, object) of each public function, method and
    property defined in ``mod``."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out.append((name, obj))
        elif inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                if isinstance(m, (staticmethod, classmethod)):
                    m = m.__func__
                if isinstance(m, property) or inspect.isfunction(m):
                    out.append((f"{name}.{mname}", m))
    return out


def _lookup(mod, qualname):
    obj = mod
    for i, part in enumerate(qualname.split(".")):
        obj = inspect.getattr_static(obj, part, None) if i else \
            getattr(obj, part, None)
        if obj is None:
            return None
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return obj


def _params(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()]


def _matches(port_params, ref_params, module):
    """The port's parameters are the reference's, in order, but for the
    Pallas-only switches of a kernel op, the additions of ``ADDED`` and the
    renames of ``RENAMED``."""
    kernel_op = module.startswith("kernels.")
    ref_params = [p for p in ref_params
                  if not (kernel_op and p in PALLAS_ONLY)]
    port_params = [p for p in port_params
                   if not (kernel_op and p in PALLAS_ONLY)
                   and not (p in ADDED and p not in ref_params)]
    return len(port_params) == len(ref_params) and all(
        q == p or q == RENAMED.get(p, (None,))[0]
        for q, p in zip(port_params, ref_params))


def _differences(module):
    """Every public name of ``repro.<module>`` the port lacks or takes
    otherwise than the tables allow."""
    ref = importlib.import_module(f"repro.{module}" if module else "repro")
    port = importlib.import_module(f"repro_torch.{module}" if module
                                   else "repro_torch")
    bad = []
    for qual, obj in _public(ref):
        key = (module, qual)
        if key in PLAIN_VERSIONS:
            if _lookup(port, PLAIN_VERSIONS[key]) is None:
                bad.append(f"{qual}: no {PLAIN_VERSIONS[key]}")
            continue
        want, _ = ONE_BY_ONE.get(key, (False, ""))
        if want is None:
            continue
        got = _lookup(port, qual)
        if got is None:
            bad.append(f"{qual}: missing")
            continue
        if isinstance(obj, property):
            if not isinstance(got, property):
                bad.append(f"{qual}: not a property")
            continue
        if not callable(got):
            bad.append(f"{qual}: not callable")
            continue
        port_params = _params(got)
        if want is False:
            if not _matches(port_params, _params(obj), module):
                bad.append(f"{qual}: {port_params} for {_params(obj)}")
        elif port_params != want:
            bad.append(f"{qual}: {port_params} != {want}")
    return bad


def test_every_module_of_the_reference_is_mirrored():
    port = set(_modules(PORT_ROOT))
    assert [m for m in REF_MODULES if m not in port] == []


def test_the_tables_name_what_the_reference_has():
    for module, qual in (*PLAIN_VERSIONS, *ONE_BY_ONE):
        mod = importlib.import_module(f"repro.{module}")
        assert _lookup(mod, qual) is not None, (module, qual)
    assert all(why for _, why in ONE_BY_ONE.values())


@pytest.mark.parametrize("module", REF_MODULES)
def test_public_functions_and_methods_take_the_references_parameters(
        module):
    assert _differences(module) == []
