"""Dependency-barrier hazards in a CUDA library's SASS.

On Hopper an instruction of variable latency (a load from shared or global
memory, a special function, a shuffle, an atomic) names in its control
word a write barrier, which its destination registers wait on, and a read
barrier, which its source registers wait on. An instruction that reads a
pending destination, or overwrites a pending register, must first wait on
that barrier (a bit of its own control word's wait mask, or a DEPBAR).
ptxas places these waits. Where it leaves one out, the reader takes the
register's old value whenever the load is slower than the instructions in
between, so the result depends on timing.

This walks each function's control-flow graph from its entry, with the
pending (barrier, register) pairs as a may-set joined at merges, and lists
every read or write of a pending register that no wait on the path
covers. Two loads or stores of one memory queue (LDS after LDS, LDG after
LDG) complete in order, so a later one's write is no hazard against an
earlier one of its queue; ptxas relies on that. Limits: predicates are not tracked (a write whose guard is the
complement of the pending writer's is not counted, as long as no
instruction in between names that predicate); an indirect branch (BRX,
a jump table) goes to the blocks after it that nothing else reaches; a
call returns to every call site.

    python -m embree_tpu_torch.perf.sass_hazards [--define NAME=VALUE ...]
        [--sass file]

builds the traversal library (with ``--define``, a copy of it with those
macros in a temporary directory), disassembles it with ``cuobjdump
-sass``, prints each function's hazards and exits 1 if there is one.
``--sass`` reads a saved listing instead. Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, NamedTuple, Tuple

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*/\* (0x[0-9a-f]{16}) \*/")
_HI = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/")
_REG = re.compile(r"\b(U?R)(\d+)(\.64|\.128)?\b")
_PRED = re.compile(r"\bU?P\d\b")
# no register destination; every register operand is read
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "REDG", "BRA", "BRX", "JMP",
            "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BAR", "WARPSYNC",
            "DEPBAR", "NOP", "MEMBAR", "YIELD", "BPT", "ERRBAR", "CCTL",
            "BREAK", "FCHK", "ENDCOLLECTIVE"}


class Instr(NamedTuple):
    addr: int
    text: str
    hi: int           # the second 64-bit word: the control bits

    @property
    def wbar(self) -> int:
        return (self.hi >> 46) & 7       # 7: none

    @property
    def rbar(self) -> int:
        return (self.hi >> 49) & 7

    @property
    def wait(self) -> int:
        return (self.hi >> 52) & 63      # a bit per barrier


class Hazard(NamedTuple):
    kind: str         # RAW, WAW or WAR
    barrier: int
    reg: str
    source: Instr     # the instruction that set the barrier
    at: Instr         # the one that did not wait on it


def parse(text: str) -> Dict[str, List[Instr]]:
    """cuobjdump -sass output: {function name: its instructions}."""
    funcs: Dict[str, List[Instr]] = {}
    cur = None
    lines = text.split("\n")
    for k, line in enumerate(lines):
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INS.search(line)
        if m and cur is not None and k + 1 < len(lines):
            hi = _HI.match(lines[k + 1])
            if hi:
                cur.append(Instr(int(m.group(1), 16), m.group(2),
                                 int(hi.group(1), 16)))
    return funcs


def _split(text: str) -> Tuple[str, str, List[str]]:
    guard = ""
    if text.startswith("@"):
        guard, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    return guard, op, [o.strip() for o in rest.split(",")] if rest else []


def _regs(operand: str, width: int = 1) -> List[str]:
    out = []
    for m in _REG.finditer(operand):
        kind, num, w = m.groups()
        n = {".64": 2, ".128": 4}.get(w, width)
        out += [f"{kind}{int(num) + j}" for j in range(n)]
    return out


def _width(op: str) -> int:
    parts = op.split(".")
    if "128" in parts:
        return 4
    return 2 if "64" in parts or "WIDE" in parts else 1


def _operands(ins: Instr) -> Tuple[List[str], List[str]]:
    """(registers read, registers written)."""
    _, op, ops = _split(ins.text)
    if op.split(".")[0] in _NO_DEST or not ops:
        return [r for o in ops for r in _regs(o)], []
    dest, srcs = ops[0], ops[1:]
    if _PRED.fullmatch(dest.lstrip("!")) or dest == "PT":
        # a predicate first (SETP, LOP3 P0, SHFL PT, ATOMG PT): a register
        # after it is a second destination
        if not srcs or not _regs(srcs[0]) and srcs[0] != "RZ":
            return [r for o in srcs for r in _regs(o)], []
        dest, srcs = srcs[0], srcs[1:]
    writes = _regs(dest, 1 if ".64" in dest else _width(op))
    return [r for o in srcs for r in _regs(o)], writes


def _queue(ins: Instr) -> str:
    """The memory queue of a load, store or atomic (its opcode's first
    letters after LD/ST/RED/ATOM: S shared, G global, C constant), else
    the empty string. Two of one queue complete in order."""
    op = _split(ins.text)[1].split(".")[0]
    m = re.fullmatch(r"(?:LD|ST|RED|ATOM)([SGC])", op)
    return m.group(1) if m else ""


def _successors(code: List[Instr]) -> List[List[int]]:
    at = {ins.addr: k for k, ins in enumerate(code)}
    succ: List[List[int]] = []
    returns, leaders, indirect = [], set(), []
    for k, ins in enumerate(code):
        guard, op, ops = _split(ins.text)
        base = op.split(".")[0]
        nxt = [k + 1] if k + 1 < len(code) else []
        if base in ("BRA", "JMP"):
            tgt = at[int(ops[-1], 16)]
            leaders.add(tgt)
            s = [tgt] + (nxt if guard or len(ops) > 1 else [])
        elif base == "CALL":
            s = [at[int(ops[-1], 16)]]
            returns += nxt
        elif base == "RET":
            s = [-1] + (nxt if guard else [])
        elif base == "EXIT":
            s = nxt if guard else []
        elif base == "BRX":
            indirect.append(k)
            s = nxt if guard else []
        else:
            s = nxt
        if base in ("BRA", "JMP", "BRX", "EXIT", "RET") and not guard \
                and len(ops) <= 1 and nxt:
            leaders.add(k + 1)
        succ.append(s)
    # the cases of a jump table: the leaders that nothing else reaches,
    # each taken as a case of the nearest indirect branch before it
    reached = {j for s in succ for j in s if j != -1} | {0}
    for j in sorted(leaders - reached):
        owner = [k for k in indirect if k < j]
        if owner:
            succ[owner[-1]].append(j)
    return [[r for x in s for r in (returns if x == -1 else [x])]
            for s in succ]


def hazards(code: List[Instr]) -> List[Hazard]:
    """Every read or write of a register whose barrier no wait covers on
    some path from the function's entry."""
    if not code:
        return []
    rw = [_operands(ins) for ins in code]
    succ = _successors(code)
    # pending: (barrier, "w" or "r", register, index of the setter, guard)
    states: List = [None] * len(code)
    states[0] = frozenset()
    work = [0]
    found: Dict[Tuple, Hazard] = {}
    while work:
        k = work.pop()
        ins = code[k]
        guard, op, ops = _split(ins.text)
        st = {e for e in states[k] if not (ins.wait >> e[0]) & 1}
        if op.startswith("DEPBAR"):
            m = re.search(r"SB(\d), (0x[0-9a-f]+|\d+)", ins.text)
            if m and int(m.group(2), 0) == 0:
                st = {e for e in st if e[0] != int(m.group(1))}
        reads, writes = rw[k]
        for bar, kind, reg, src, g in st:
            if g and guard and g.lstrip("@!") == guard.lstrip("@!") and \
                    g.startswith("@!") != guard.startswith("@!"):
                continue    # complementary guards: one of the two ran
            label = ("RAW" if kind == "w" and reg in reads
                     else "WAW" if kind == "w" and reg in writes
                     else "WAR" if kind == "r" and reg in writes else None)
            if label in ("WAW", "WAR") and _queue(code[src]) and \
                    _queue(code[src]) == _queue(ins):
                continue    # one queue, in order: the earlier one is done
            if label:
                found[(label, bar, reg, src, k)] = Hazard(
                    label, bar, reg, code[src], ins)
        named = set(_PRED.findall(" ".join(ops)))
        if named:   # a predicate named again: guards before it no longer hold
            st = {(b, kd, r, s, "" if g.lstrip("@!") in named else g)
                  for b, kd, r, s, g in st}
        if ins.wbar != 7:
            st |= {(ins.wbar, "w", r, k, guard) for r in writes}
        if ins.rbar != 7:
            st |= {(ins.rbar, "r", r, k, guard) for r in reads}
        fs = frozenset(st)
        for j in succ[k]:
            if states[j] is None or not fs <= states[j]:
                states[j] = fs if states[j] is None else states[j] | fs
                work.append(j)
    return sorted(found.values(), key=lambda h: (h.source.addr, h.at.addr))


def disassemble(library: str) -> str:
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", library], check=True, text=True,
                          capture_output=True).stdout


def library_sass(name: str, defines: List[str]) -> str:
    """The SASS of the named library, or of a copy built with extra
    macros."""
    from embree_tpu_torch import _build
    if not defines:
        return disassemble(_build.ensure(name))
    base = _build.TARGETS[name]
    root = tempfile.mkdtemp()
    copy = _build.Target(os.path.join(root, os.path.basename(base.lib)),
                         base.units, base.headers,
                         base.flags + tuple(f"-D{d}" for d in defines),
                         base.link)
    _build.build_all([name], {name: copy})
    try:
        return disassemble(copy.path)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def report(funcs: Dict[str, List[Instr]]) -> int:
    """Print each function's hazards; returns their count."""
    total = 0
    for name, code in funcs.items():
        found = hazards(code)
        total += len(found)
        print(f"{name}: {len(code)} instructions, {len(found)} hazards")
        for h in found:
            print(f"  {h.kind} on barrier {h.barrier} for {h.reg}: "
                  f"{h.source.addr:#x} {h.source.text!r} -> {h.at.addr:#x} "
                  f"{h.at.text!r}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--sass", help="a saved cuobjdump -sass listing")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as f:
            text = f.read()
    else:
        sys.path.insert(0, os.getcwd())
        text = library_sass("traverse_cuda", args.define)
    funcs = parse(text)
    n = report(funcs)
    print(f"{n} hazards in {len(funcs)} functions")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
