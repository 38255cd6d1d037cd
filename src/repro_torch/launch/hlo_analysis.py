"""Trip-count-aware analysis of partitioned HLO text: the port's own copy
of the JAX package's ``launch/hlo_analysis.py``, so that a user of the
port can read any saved HLO dump (an XLA program compiled elsewhere)
without JAX.  Nothing in PyTorch emits HLO: the port's own dry run traces
on the ``meta`` device instead (:mod:`repro_torch.launch.trace_analysis`).
Pure text functions over ``re``; ``analyze`` and ``top_dots`` return the
reference's dicts.

``compiled.cost_analysis()`` visits every computation ONCE — a collective
or matmul inside a scanned layer body is counted once even though it
executes n_layers times.  For scan-over-layers models that understates
FLOPs/bytes by ~L×, so the roofline is derived here instead:

  1. parse the module into computations and instructions;
  2. recover while-loop trip counts from the loop-condition's comparison
     constant, and propagate multipliers along the call graph
     (while bodies, fusions, calls, conditionals*);
  3. accumulate, weighted by multiplier:
       · dot FLOPs          2 · |result| · Π(contracting dims)
       · HBM traffic        Σ (operand + result bytes) of top-level
                            fusions / dots / copies / DUS / collectives —
                            each top-level op reads operands from and
                            writes results to HBM on real hardware;
       · collective bytes   operand bytes of all-gather / all-reduce /
                            reduce-scatter / all-to-all / collective-permute.

  *conditional branches are counted once (an upper bound of one branch).
"""
from __future__ import annotations

import re

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(
    r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred|f8e4m3fn|f8e5m2|"
    r"c64|c128)\[([\d,]*)\]")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->\s*.+\{\s*$")
_TRIP_RE = re.compile(r'known_trip_count[^}]*"n":"(\d+)"')
_INST_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_CALL_ATTR_RE = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _shape_list_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        n = 1
        for d in m.group(2).split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[m.group(1)]
    return total


def _result_dims(text: str):
    """First shape in text → (dtype, dims list)."""
    m = _SHAPE_RE.search(text)
    if not m:
        return None, []
    dims = [int(d) for d in m.group(2).split(",") if d]
    return m.group(1), dims


class Instruction:
    __slots__ = ("name", "body", "opcode", "result_bytes", "operands")

    def __init__(self, name, body):
        self.name = name
        self.body = body
        # opcode = first word after the result type(s)
        m = re.search(r"\)?\s([a-z][\w\-]*)\(", body)
        self.opcode = m.group(1) if m else ""
        # result type: prefix of body up to opcode
        head = body[:m.start()] if m else body
        self.result_bytes = _shape_list_bytes(head)
        # operand names inside the first paren group after opcode
        self.operands = []
        if m:
            inner = body[m.end():]
            depth, end = 1, len(inner)
            for i, ch in enumerate(inner):
                depth += (ch == "(") - (ch == ")")
                if depth == 0:
                    end = i
                    break
            group = inner[:end]
            if "%" in group:
                # modern printers emit typed operands:
                #   dot(f32[128,128]{1,0} %lhs.4, f32[128,128]{1,0} %rhs.8)
                # — the references are exactly the %-prefixed tokens
                self.operands = re.findall(r"%([\w.\-]+)", group)
            else:
                # untyped operand lists: every bare token is a reference
                self.operands = [t for t in re.findall(r"([\w.\-]+)", group)
                                 if not re.fullmatch(r"[\d.\-]+", t)
                                 and t not in _DTYPE_BYTES]


def parse_computations(hlo: str) -> dict:
    comps = {}
    cur, cur_name = None, None
    for line in hlo.splitlines():
        mc = _COMP_RE.match(line.strip()) if "{" in line else None
        if mc and ("->" in line):
            cur_name = mc.group(1)
            cur = []
            comps[cur_name] = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        mi = _INST_RE.match(line)
        if mi:
            cur.append(Instruction(mi.group(1), mi.group(2)))
    return comps


def _trip_count(cond_insts) -> int:
    consts = []
    for inst in cond_insts:
        consts += [int(c) for c in _CONST_RE.findall(inst.body)]
    return max(consts) if consts else 1


def compute_multipliers(comps: dict) -> dict:
    """Multiplier per computation = product of enclosing while trip counts.

    Trip counts come from XLA's ``known_trip_count`` backend config on the
    while op (exact), falling back to the largest constant in the loop
    condition.  Multipliers propagate along the call graph (fusion calls,
    to_apply, while body/condition, conditional branches).
    """
    called = set()
    calls = {name: [] for name in comps}   # name -> [(callee, factor)]
    for name, insts in comps.items():
        for inst in insts:
            callees = [c for c in _CALL_ATTR_RE.findall(inst.body)]
            for group in _BRANCHES_RE.findall(inst.body):
                callees += [c.strip().lstrip("%") for c in group.split(",")]
            if not callees:
                continue
            factor = 1
            if inst.opcode == "while":
                mt = _TRIP_RE.search(inst.body)
                if mt:
                    factor = int(mt.group(1))
                else:
                    mcond = re.search(r"condition=%?([\w.\-]+)", inst.body)
                    if mcond and mcond.group(1) in comps:
                        factor = _trip_count(comps[mcond.group(1)])
            for c in callees:
                if c in comps:
                    calls[name].append((c, factor))
                    called.add(c)
    roots = [n for n in comps if n not in called]
    mult = {n: 0 for n in comps}
    stack = [(r, 1) for r in roots]
    guard = 0
    while stack and guard < 1_000_000:
        guard += 1
        name, m = stack.pop()
        if m <= mult[name]:
            continue
        mult[name] = m
        for callee, factor in calls[name]:
            stack.append((callee, m * factor))
    return mult


_DOT_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def top_dots(hlo: str, k: int = 15) -> list:
    """The k biggest matmuls by trip-corrected FLOPs — the §Perf profile."""
    comps = parse_computations(hlo)
    mult = compute_multipliers(comps)
    shapes = {}
    for insts in comps.values():
        for inst in insts:
            head = inst.body.split(inst.opcode + "(")[0] if inst.opcode \
                else inst.body
            dt, dims = _result_dims(head)
            shapes[inst.name] = (dt, dims)
    out = []
    for cname, insts in comps.items():
        m = mult.get(cname, 1) or 1
        for inst in insts:
            if inst.opcode != "dot":
                continue
            _, dims = shapes.get(inst.name, (None, []))
            cm = _DOT_CONTRACT_RE.search(inst.body)
            csize = 1
            lhs_dims = []
            if cm and inst.operands:
                lhs_dims = shapes.get(inst.operands[0], (None, []))[1]
                for ci in cm.group(1).split(","):
                    if ci and int(ci) < len(lhs_dims):
                        csize *= lhs_dims[int(ci)]
            n = 1
            for d in dims:
                n *= d
            meta = re.search(r'op_name="([^"]*)"', inst.body)
            out.append({
                "flops": 2.0 * n * csize * m,
                "result": dims, "contract": csize, "mult": m,
                "comp": cname,
                "op_name": meta.group(1)[-90:] if meta else inst.name,
            })
    out.sort(key=lambda d: -d["flops"])
    return out[:k]


def analyze(hlo: str, sizes_hint: dict | None = None) -> dict:
    comps = parse_computations(hlo)
    mult = compute_multipliers(comps)
    # global name → result bytes / dims (names are unique per module)
    shapes = {}
    for insts in comps.values():
        for inst in insts:
            head = inst.body.split(inst.opcode + "(")[0] if inst.opcode else inst.body
            dt, dims = _result_dims(head)
            shapes[inst.name] = (dt, dims, inst.result_bytes)

    flops = 0.0
    dot_traffic = 0.0       # matmul operands/results — real HBM crossings
    dus_traffic = 0.0       # dynamic-update-slice writes (KV-cache updates)
    unfused_traffic = 0.0   # everything at top level (CPU-HLO upper bound)
    coll = {k: 0.0 for k in COLLECTIVES}
    coll_count = 0
    # ops whose operands/results cross HBM when they appear at top level
    # (inside fused computations the intermediates stay in registers/VMEM)
    top_level = ("fusion", "dot", "copy", "dynamic-update-slice",
                 "convolution", "scatter", "gather",
                 "sort", "concatenate", "dynamic-slice", "pad",
                 "reduce", "transpose", "convert", "add", "multiply",
                 "select", "tanh", "exp", "broadcast") + COLLECTIVES

    for cname, insts in comps.items():
        m = mult.get(cname, 1) or 1
        fused_ctx = cname.startswith(("fused", "wrapped"))
        for inst in insts:
            op = inst.opcode
            opb = sum(shapes.get(o, (None, [], 0))[2] for o in inst.operands)
            if op == "dot":
                _, dims, _ = shapes.get(inst.name, (None, [], 0))
                cm = _DOT_CONTRACT_RE.search(inst.body)
                csize = 1
                if cm and inst.operands:
                    lhs = shapes.get(inst.operands[0], (None, [], 0))[1]
                    for ci in cm.group(1).split(","):
                        if ci and int(ci) < len(lhs):
                            csize *= lhs[int(ci)]
                n = 1
                for d in dims:
                    n *= d
                flops += 2.0 * n * csize * m
                dot_traffic += (opb + inst.result_bytes) * m
            if op in ("dynamic-update-slice", "scatter"):
                # in-place update: traffic = the update slice (read) + the
                # written region — NOT the whole aliased target buffer
                upd = (shapes.get(inst.operands[1], (None, [], 0))[2]
                       if len(inst.operands) > 1 else inst.result_bytes)
                dus_traffic += 2.0 * upd * m
            base = op.split("-start")[0]
            if base in COLLECTIVES:
                coll[base] += opb * m
                coll_count += 1
            if not fused_ctx and op in top_level:
                unfused_traffic += (opb + inst.result_bytes) * m

    return {
        "dot_flops": flops,
        # memory roofline term: matmul + cache-update traffic.  Elementwise
        # chains fuse on TPU (unfused CPU-HLO counting overstates traffic
        # 10–50×); kept separately as an upper bound.
        "hbm_traffic_bytes": dot_traffic + dus_traffic,
        "unfused_traffic_bytes": unfused_traffic,
        "dus_traffic_bytes": dus_traffic,
        "collective_bytes": {**{k: coll[k] for k in COLLECTIVES},
                             "total": sum(coll.values()),
                             "count": coll_count},
        "n_computations": len(comps),
    }
