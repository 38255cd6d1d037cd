"""spec-roundtrip (AIR004): every spec field survives the JSON round trip.

The port's frozen spec dataclasses (``TuneSpec`` / ``ServeSpec`` /
``RetryPolicy`` / ``FleetSpec`` / ``ShardMap``) are its wire format, the
same as the JAX package's: index files record the ``TuneSpec``, the
fleet rebuilds per-shard ``ServeSpec``\\ s from JSON, and files written
by either package open in the other.  ``FleetSpec.to_dict`` is
hand-written, so adding a field and forgetting the dict literal silently
drops it — the spec saves, loads, and quietly reverts that knob to its
default.  Grep cannot catch this; importing and introspecting can.

This is a :class:`ProjectRule`: it runs once, imports the spec modules,
and for every registered class checks that

* each declared dataclass field appears in ``to_dict()``'s keys,
* ``to_json()`` produces valid JSON,
* ``from_json(to_json(x)) == x`` for a default instance, and
* perturbing each scalar field (via ``dataclasses.replace``) still
  round-trips — i.e. the field is actually *restored*, not defaulted.

Findings anchor at the class definition line in the spec module.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os

from ..core import Finding, ProjectRule, norm_path

#: (module, class, builder) — builder returns a valid default instance
SPEC_TARGETS = [
    ("repro_torch.api.spec", "TuneSpec", lambda cls: cls()),
    ("repro_torch.api.spec", "RetryPolicy", lambda cls: cls()),
    ("repro_torch.api.spec", "ServeSpec", lambda cls: cls()),
    ("repro_torch.fleet.spec", "ShardMap", lambda cls: cls(bounds=(16, 32))),
    ("repro_torch.fleet.spec", "FleetSpec", lambda cls: cls()),
]

#: module suffixes that gate the rule: only run when the scanned paths
#: actually include the spec sources (scanning tests/ alone skips it)
_GATE_SUFFIXES = ("repro_torch/api/spec.py", "repro_torch/fleet/spec.py")


def _perturb(value):
    """A different-but-plausible value for a scalar field, else None."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value + 0.5
    if isinstance(value, str):
        return value + "_x"
    return None


def roundtrip_problems(cls, build) -> list[str]:
    """Check one spec class; → list of human-readable problems.

    Exposed standalone so tests can point it at deliberately broken
    dataclasses without going through the import machinery.
    """
    problems: list[str] = []
    try:
        x = build(cls)
    except Exception as e:
        return [f"could not construct a default instance: {e!r}"]
    field_names = [f.name for f in dataclasses.fields(cls)]

    try:
        d = cls.to_dict(x) if hasattr(cls, "to_dict") else None
    except Exception as e:
        return [f"to_dict() raised: {e!r}"]
    if d is None:
        return ["spec class has no to_dict()"]
    missing = [n for n in field_names if n not in d]
    for n in missing:
        problems.append(f"field '{n}' missing from to_dict() — it will "
                        f"silently revert to its default on reload")

    if not hasattr(cls, "from_json") or not hasattr(cls, "to_json"):
        problems.append("spec class lacks to_json()/from_json()")
        return problems
    try:
        blob = x.to_json()
        json.loads(blob)
    except Exception as e:
        problems.append(f"to_json() did not produce valid JSON: {e!r}")
        return problems
    try:
        y = cls.from_json(blob)
    except Exception as e:
        problems.append(f"from_json(to_json(x)) raised: {e!r}")
        return problems
    if y != x:
        problems.append("from_json(to_json(x)) != x for a default instance")

    # perturb each scalar field and make sure the new value survives
    for f in dataclasses.fields(cls):
        if f.name in missing:
            continue  # already reported above
        current = getattr(x, f.name)
        new = _perturb(current)
        if new is None:
            continue
        try:
            z = dataclasses.replace(x, **{f.name: new})
        except Exception:
            continue  # validation rejects the perturbed value — fine
        try:
            z2 = cls.from_json(z.to_json())
        except Exception as e:
            problems.append(f"round trip with perturbed field '{f.name}' "
                            f"raised: {e!r}")
            continue
        if getattr(z2, f.name) != new:
            problems.append(f"field '{f.name}' not restored by "
                            f"from_json(to_json(x)) — got "
                            f"{getattr(z2, f.name)!r}, expected {new!r}")
    return problems


class SpecRoundtripRule(ProjectRule):
    name = "spec-roundtrip"
    code = "AIR004"
    description = ("every declared field of the frozen spec dataclasses "
                   "appears in to_dict() and is restored by "
                   "from_json(to_json(x))")

    def check_project(self, files):
        if not any(norm_path(p).endswith(s)
                   for p in files for s in _GATE_SUFFIXES):
            return
        import importlib
        for mod_name, cls_name, build in SPEC_TARGETS:
            try:
                mod = importlib.import_module(mod_name)
                cls = getattr(mod, cls_name)
            except Exception as e:
                yield Finding(rule=self.name, code=self.code,
                              path=mod_name.replace(".", "/") + ".py",
                              line=1, col=1,
                              message=f"could not import {mod_name}."
                                      f"{cls_name}: {e!r}")
                continue
            path, line = _anchor(cls, files)
            for problem in roundtrip_problems(cls, build):
                yield Finding(rule=self.name, code=self.code, path=path,
                              line=line, col=1,
                              message=f"{cls_name}: {problem}")


def _anchor(cls, files) -> tuple[str, int]:
    """(scanned-relative path, class def line) for findings/allows."""
    try:
        src_file = inspect.getsourcefile(cls)
        src, line = inspect.getsourcelines(cls)
    except (OSError, TypeError):
        return cls.__module__.replace(".", "/") + ".py", 1
    # skip decorator lines so the anchor is the ``class X:`` statement
    for i, ln in enumerate(src):
        if ln.lstrip().startswith("class "):
            line += i
            break
    src_norm = norm_path(os.path.abspath(src_file))
    for p in files:
        if src_norm.endswith(norm_path(p).lstrip("./")):
            return p, line
    return os.path.relpath(src_file), line
