"""Per-chip collective wire-bytes model over optimized HLO.

Used by scripts/measure_halo_payload.py (layout comparison tables, PERF.md)
and tests/test_wire_bytes.py (CI regression budget), so halo/GSPMD lowering
regressions cannot land silently (a GSPMD fallback turns the 0.34 MB/step
sharded train step into 2.58 MB).

Ring model per collective (result = output shape bytes, g = replica-group
size): all-gather / all-to-all / collective-permute move (g-1)/g x result
per chip, all-reduce 2(g-1)/g x operand, reduce-scatter (g-1) x result.
Conditionals contribute their CHEAPEST branch — for the fetch-routed halo
gathers (halo.py::_fetch_or_psum_gather) that is the steady-state
no-overflow fetch path; the psum fallback only runs on capacity overflow.
"""

from __future__ import annotations

import re

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(shape_str: str) -> int:
    """Bytes of one 'f32[4,128]{...}'-style HLO shape; tuples summed."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _parse_computations(hlo_text: str):
    """Split optimized HLO into {computation_name: [op lines]} and find the
    entry computation name."""
    comps, entry, cur = {}, None, None
    for line in hlo_text.splitlines():
        m = re.match(r"(ENTRY )?%?([\w.\-]+) (?:\([^)]*\) -> |\().*\{", line)
        if m and not line.startswith(" "):
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
            continue
        if cur is not None and line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line.strip())
    return comps, entry


_CALLEE_RE = re.compile(
    r"(?:to_apply|body|condition|true_computation|false_computation)="
    r"%?([\w.\-]+)|branch_computations=\{([^}]*)\}|"
    r"called_computations=\{([^}]*)\}")


def _op_callees(line: str):
    names = []
    for m in _CALLEE_RE.finditer(line):
        if m.group(1):
            names.append(m.group(1))
        else:
            names += [s.strip().lstrip("%") for s in
                      (m.group(2) or m.group(3)).split(",") if s.strip()]
    return names


def collective_bytes(hlo_text: str, p: int) -> dict:
    """Per-chip WIRE bytes of the executed path, by collective kind."""
    comps, entry = _parse_computations(hlo_text)

    def group_size(line):
        """Replica-group size of a collective (ring factor base); falls
        back to the full mesh.  Handles both the iota form
        ``replica_groups=[4,2]<=[8]`` (4 groups of 2) and the literal form
        ``replica_groups={{0,1,2,3},{...}}``."""
        m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
        if m:
            return max(1, int(m.group(2)))
        m = re.search(r"replica_groups=\{\{([^}]*)\}", line)
        if m and m.group(1).strip():
            return len(m.group(1).split(","))
        return p

    def op_bytes(line):
        m = re.match(r"\S+ = (\(?[^)]*\)?) (\S+?)\(", line)
        if not m:
            return {}
        op = m.group(2).split(".")[0]
        if op.endswith("-start"):
            op = op[:-6]
        if op not in COLLECTIVES:
            return {}
        b = shape_bytes(m.group(1))
        g = group_size(line)
        if g <= 1:
            return {}
        if op == "all-reduce":
            b = 2 * b * (g - 1) // g
        elif op == "reduce-scatter":
            b = b * (g - 1)
        else:
            b = b * (g - 1) // g
        return {op: b}

    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        memo[name] = {}          # cycle guard
        total = {}
        for line in comps.get(name, ()):
            for k, v in op_bytes(line).items():
                total[k] = total.get(k, 0) + v
            callees = _op_callees(line)
            if not callees:
                continue
            subs = [walk(c) for c in callees if c in comps]
            if "conditional" in line and subs:
                subs = [min(subs, key=lambda s: sum(s.values()))]
            for s in subs:
                for k, v in s.items():
                    total[k] = total.get(k, 0) + v
        memo[name] = total
        return total

    return walk(entry)
