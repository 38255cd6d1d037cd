"""The port's airlint (``repro_torch.analysis``) against the JAX package's.

Shared fixtures — the seeded sources of ``tests/test_analysis.py`` for
AIR000–AIR003, AIR005 and AIR999 — go through both airlints, which must
report the same (code, line, col).  The port's own contracts get failing
fixtures of their own: the pread seam at ``repro_torch/serve/backend.py``
(AIR001), a spec field missing from ``to_dict`` (AIR004), and kernel
packages with a ``ref`` fallback in an ``except``, a module-level build,
or no device dispatch (AIR006).  The gate: the port's airlint over
``src/repro_torch`` is clean.  The CLI keeps the reference's exit codes
and JSON schema."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import run_checks as ref_run_checks
from repro.analysis.rules import rules_by_name as ref_rules_by_name
from repro_torch.analysis import ALL_RULES, run_checks
from repro_torch.analysis.__main__ import JSON_SCHEMA_VERSION, main
from repro_torch.analysis.rules import rules_by_name
from repro_torch.analysis.rules import spec_roundtrip as spec_roundtrip_mod
from repro_torch.analysis.rules.kernel_fallback import \
    KernelFallbackShapeRule
from repro_torch.analysis.rules.spec_roundtrip import roundtrip_problems

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def write(path, src):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return str(path)


def check(paths, rule_names, ref=False):
    run, by_name = ((ref_run_checks, ref_rules_by_name) if ref
                    else (run_checks, rules_by_name))
    findings, _ = run([str(p) for p in paths], by_name(rule_names))
    return findings


# ---------------------------------------------------------------------------
# shared fixtures: (relative path, rules, source, expected (code, line))
# ---------------------------------------------------------------------------
SHARED = {
    "pread-raw": ("reader.py", ["pread-seam"], """\
        import os

        def f(fd, path):
            raw = os.pread(fd, 4, 0)
            fd2 = os.open(path, os.O_RDONLY)
            return raw, fd2
        """, [("AIR001", 4), ("AIR001", 5)]),
    "lock-stats-cache-pread": ("engine.py", ["lock-discipline"], """\
        class Svc:
            def f(self, st):
                st.stats.hits += 1
                st.stats.record_read(1)
                st.cache.get(1)
                with self._mu:
                    st.stats.hits += 1
                    st.storage.pread(4, 0)
        """, [("AIR002", 3), ("AIR002", 4), ("AIR002", 5), ("AIR002", 8)]),
    "lock-except-blocks": ("engine.py", ["lock-discipline"], """\
        class Svc:
            def f(self, st):
                try:
                    st.storage.pread(4, 0)
                except OSError:
                    with self._mu:
                        st.stats.degraded_runs += 1
        """, []),
    "lock-no-idiom": ("other.py", ["lock-discipline"], """\
        def f(st):
            st.stats.hits += 1
        """, []),
    "typed-broad-in-serve": ("serve/svc.py", ["typed-error-flow"], """\
        def f():
            try:
                return 1
            except Exception:
                return None
        """, [("AIR003", 4)]),
    "typed-shield-reraise": ("fleet/svc.py", ["typed-error-flow"], """\
        def f():
            try:
                return 1
            except StorageError:
                return 2
            except Exception:
                return None

        def g():
            try:
                return 1
            except Exception:
                raise
        """, []),
    "typed-out-of-scope": ("core/x.py", ["typed-error-flow"], """\
        def f():
            try:
                return 1
            except Exception:
                return None
        """, []),
    "shim-imports-calls-kwargs": ("caller.py", ["shim-discipline"], """\
        from repro.core.serialize import load_index

        def g(path, data):
            return load_index(path, data)

        def h(path, IndexService):
            return IndexService(path, cache_bytes=(1,), use_device=True)
        """, [("AIR005", 1), ("AIR005", 4), ("AIR005", 7)]),
    "shim-init-reexport": ("pkg/__init__.py", ["shim-discipline"], """\
        from repro.core.serialize import load_index
        """, []),
    "allow-justified": ("reader.py", ["pread-seam"], """\
        import os

        def f(fd):
            return os.pread(fd, 4, 0)  # airlint: allow[pread-seam] -- probe
        """, []),
    "allow-standalone": ("reader.py", ["pread-seam"], """\
        import os

        def f(fd):
            # airlint: allow[pread-seam] -- offline path, justified over
            # two comment lines that both belong to this suppression
            return os.pread(fd, 4, 0)
        """, []),
    "allow-without-reason": ("reader.py", ["pread-seam"], """\
        import os

        def f(fd):
            return os.pread(fd, 4, 0)  # airlint: allow[pread-seam]
        """, [("AIR000", 4), ("AIR001", 4)]),
    "allow-other-rule": ("reader.py", ["pread-seam"], """\
        import os

        def f(fd):
            return os.pread(fd, 4, 0)  # airlint: allow[lock-discipline] -- x
        """, [("AIR001", 4)]),
    "syntax-error": ("broken.py", ["pread-seam"], "def f(:\n",
                     [("AIR999", 1)]),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixtures_give_the_references_findings(tmp_path, case):
    rel, rules, src, expected = SHARED[case]
    p = write(tmp_path / rel, src)
    got = check([p], rules)
    want = check([p], rules, ref=True)
    assert [(f.code, f.line, f.col) for f in got] == \
        [(f.code, f.line, f.col) for f in want]
    assert [(f.code, f.line) for f in got] == expected
    assert all(f.path == p for f in got)


# ---------------------------------------------------------------------------
# AIR001: the port's seam
# ---------------------------------------------------------------------------
_SEAM_SRC = """\
    import os

    def pread_full(fd):
        return os.pread(fd, 4, 0)
    """


def test_pread_seam_exempts_the_ports_seam_only(tmp_path):
    port_seam = write(tmp_path / "repro_torch" / "serve" / "backend.py",
                      _SEAM_SRC)
    ref_seam = write(tmp_path / "repro" / "serve" / "backend.py", _SEAM_SRC)
    assert check([port_seam], ["pread-seam"]) == []
    assert [(f.code, f.line) for f in check([ref_seam], ["pread-seam"])] \
        == [("AIR001", 4)]
    # the reference's airlint sees it the other way round
    assert check([ref_seam], ["pread-seam"], ref=True) == []
    assert len(check([port_seam], ["pread-seam"], ref=True)) == 1


# ---------------------------------------------------------------------------
# AIR004: the port's specs
# ---------------------------------------------------------------------------
_BROKEN_SPEC_SRC = """\
import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class BrokenTorchSpec:
    a: int = 1
    b: int = 2

    def to_dict(self):
        return {"a": self.a}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))
"""


def test_spec_roundtrip_flags_a_field_missing_from_to_dict(tmp_path,
                                                           monkeypatch):
    p = write(tmp_path / "broken_torch_spec.py", _BROKEN_SPEC_SRC)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(
        spec_roundtrip_mod, "SPEC_TARGETS",
        [("broken_torch_spec", "BrokenTorchSpec", lambda c: c())])
    rule = spec_roundtrip_mod.SpecRoundtripRule()
    # the gate opens on the port's spec module only
    assert list(rule.check_project(
        [p, os.path.join(REPO, "src/repro/api/spec.py")])) == []
    fs = list(rule.check_project([p, os.path.join(PORT, "api/spec.py")]))
    assert fs and all((f.path, f.line, f.code) == (p, 6, "AIR004")
                      for f in fs)
    assert any("field 'b' missing from to_dict()" in f.message for f in fs)


def test_the_ports_specs_round_trip_clean():
    import importlib
    names = []
    for mod, cls_name, build in spec_roundtrip_mod.SPEC_TARGETS:
        assert mod.startswith("repro_torch.")
        cls = getattr(importlib.import_module(mod), cls_name)
        assert roundtrip_problems(cls, build) == [], (mod, cls_name)
        names.append(cls_name)
    assert names == ["TuneSpec", "RetryPolicy", "ServeSpec", "ShardMap",
                     "FleetSpec"]


# ---------------------------------------------------------------------------
# AIR006: the port's kernel contract
# ---------------------------------------------------------------------------
_GOOD_OPS = """\
    from . import kernel, ref

    def run(x):
        if x.device.type == "cuda":
            return kernel.run_cuda(x)
        return ref.run_ref(x)
    """


def _kernel_pkg(tmp_path, name, ops=_GOOD_OPS, kernel="X = 1\n",
                ref="def run_ref(x):\n    return x\n",
                init="from .ops import run\n"):
    root = tmp_path / "repro_torch" / "kernels" / name
    files = [write(root / "__init__.py", init), write(root / "ops.py", ops),
             write(root / "kernel.py", kernel)]
    if ref is not None:
        files.append(write(root / "ref.py", ref))
    return files


def _air006(files):
    return [(os.path.basename(f.path), f.line, f.message)
            for f in KernelFallbackShapeRule().check_project(files)]


def test_kernel_shape_accepts_a_well_formed_package(tmp_path):
    assert _air006(_kernel_pkg(tmp_path, "good")) == []
    backend_ops = """\
        from . import ref

        def run(x, backend="cuda"):
            if backend == "numpy":
                return ref.run_ref(x)
            return x
        """
    assert _air006(_kernel_pkg(tmp_path, "by_backend",
                               ops=backend_ops)) == []


def test_kernel_shape_flags_a_ref_fallback_in_an_except(tmp_path):
    ops = """\
        from . import kernel, ref
        from .ref import run_ref

        def run(x):
            if x.device.type == "cuda":
                try:
                    return kernel.run_cuda(x)
                except RuntimeError:
                    return ref.run_ref(x)
            return ref.run_ref(x)

        def run2(x):
            try:
                return kernel.run_cuda(x)
            except Exception:
                return run_ref(x)
        """
    got = _air006(_kernel_pkg(tmp_path, "fallback", ops=ops))
    assert [(f, line) for f, line, _ in got] == [("ops.py", 8),
                                                 ("ops.py", 15)]
    assert all("fall back" in m for _, _, m in got)


def test_kernel_shape_flags_module_level_builds(tmp_path):
    kernel = """\
        import subprocess
        import triton
        from torch.utils import cpp_extension

        from .._cuda import CudaLibrary

        LIB = CudaLibrary("k", [])
        EXT = cpp_extension.load(name="k", sources=["k.cu"])
        subprocess.run(["nvcc", "-c", "k.cu"])
        LIB.build()
        LAZY = lambda: LIB.build()


        def launch(x):
            import triton.language  # noqa: F401
            return LIB.build()
        """
    got = _air006(_kernel_pkg(tmp_path, "eager", kernel=kernel))
    assert [(f, line) for f, line, _ in got] == [
        ("kernel.py", 2), ("kernel.py", 8), ("kernel.py", 9),
        ("kernel.py", 10)]
    assert all("at module level" in m for _, _, m in got)


def test_kernel_shape_flags_missing_pieces_and_dispatch(tmp_path):
    ops = """\
        def run(x):
            return x
        """
    got = _air006(_kernel_pkg(tmp_path, "bare", ops=ops, ref=None,
                              init="VERSION = 1\n"))
    msgs = [m for _, _, m in got]
    assert any("missing ref.py" in m for m in msgs)
    assert any("does not re-export from .ops" in m for m in msgs)
    assert any("dispatches neither" in m for m in msgs)


def test_kernel_shape_accepts_the_ports_kernels():
    files = [os.path.join(r, n) for r, _, ns in
             os.walk(os.path.join(PORT, "kernels")) for n in ns
             if n.endswith(".py")]
    pkgs = {os.path.basename(os.path.dirname(f)) for f in files
            if os.path.basename(os.path.dirname(f)) != "kernels"}
    assert pkgs == {"candidate_score", "decode_attention",
                    "flash_attention", "fused_descent", "index_lookup"}
    assert _air006(files) == []


# ---------------------------------------------------------------------------
# the gate and the CLI
# ---------------------------------------------------------------------------
def test_the_port_is_clean_under_all_rules():
    findings, n = run_checks([PORT], ALL_RULES)
    assert n > 50
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)


def test_rules_are_the_references():
    from repro.analysis import ALL_RULES as REF_RULES
    assert [(r.name, r.code) for r in ALL_RULES] == \
        [(r.name, r.code) for r in REF_RULES]


def test_cli_exit_codes_and_json_schema(tmp_path, capsys):
    bad = write(tmp_path / "bad.py", """\
        import os

        def f(fd):
            return os.pread(fd, 4, 0)
        """)
    clean = write(tmp_path / "clean.py", "x = 1\n")
    report = tmp_path / "airlint.json"
    ref_report = tmp_path / "ref.json"

    assert main([clean]) == 0
    assert main(["--rules", "no-such-rule", clean]) == 2
    assert main([bad, "--rules", "pread-seam", "--json", str(report)]) == 1
    out = capsys.readouterr().out
    assert f"{bad}:4:" in out and "AIR001" in out
    from repro.analysis.__main__ import main as ref_main
    assert ref_main([bad, "--rules", "pread-seam", "--json",
                     str(ref_report)]) == 1

    blob = json.loads(report.read_text())
    ref_blob = json.loads(ref_report.read_text())
    assert set(blob) == set(ref_blob) == {"version", "paths", "rules",
                                          "files_scanned", "findings"}
    assert blob["version"] == JSON_SCHEMA_VERSION == ref_blob["version"]
    assert blob["files_scanned"] == 1 and blob["paths"] == [bad]
    assert [{k: r[k] for k in ("name", "code")} for r in blob["rules"]] == \
        [{"name": "pread-seam", "code": "AIR001"}]
    (f,) = blob["findings"]
    (rf,) = ref_blob["findings"]
    assert set(f) == set(rf) == {"rule", "code", "path", "line", "col",
                                 "message"}
    assert {k: f[k] for k in ("rule", "code", "path", "line", "col")} == \
        {k: rf[k] for k in ("rule", "code", "path", "line", "col")}


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ("AIR001", "AIR002", "AIR003", "AIR004", "AIR005",
                 "AIR006"):
        assert code in out


def test_the_module_scans_the_port_by_default(tmp_path):
    """``python -m repro_torch.analysis`` from the repo root scans
    ``src/repro_torch`` and exits 0; on a failing fixture it exits 1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                        cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 findings" in ok.stderr
    n = int(ok.stderr.split(" in ")[1].split()[0])
    assert n == sum(f.endswith(".py") for _, _, fs in os.walk(PORT)
                    for f in fs)
    files = _kernel_pkg(tmp_path, "eager", kernel="import triton\n")
    bad = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          os.path.dirname(files[0])], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "AIR006" in bad.stdout
