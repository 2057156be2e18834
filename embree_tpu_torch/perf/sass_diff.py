"""Did a change leave the other traversal kernels as they were? Build the
traversal library from this tree and from another tree's sources, on the
card's toolkit, and compare each kernel's SASS and ptxas line.

    python -m embree_tpu_torch.perf.sass_diff --other _checkout/parent
        [--out file.json]

``--other``: the root of another tree (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Both libraries are built at once with ``_build.py``'s flags; each kernel
(``cuobjdump -sass``, one block per function) is identical, differs, or
exists in one tree only, and its registers, stack frame and spills are
printed beside the other tree's. Needs ``nvcc`` and ``cuobjdump`` (the
card's machine), not a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

from .. import _build

ENTRY = r"(traverse_kernel|persistent_kernel)I((?:Lb[01]E)+)E"


def _key(name):
    """(entry, template flags) of a mangled kernel name, else None."""
    m = re.search(ENTRY, name)
    if m is None:
        return None
    return m.group(1), tuple(int(b) for b in re.findall(r"Lb([01])E",
                                                         m.group(2)))


def ptxas_lines(log):
    """{(entry, flags): {registers, stack, spill_st, spill_ld}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur is not None and m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_st=int(m.group(2)),
                spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return out


def sass(path):
    """{(entry, flags): SASS lines} of a library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _key(m.group(1))
            if cur is not None:
                funcs[cur] = []
            continue
        if cur is not None:
            funcs[cur].append(line)
    return funcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    base = _build.TARGETS["traverse_cuda"]
    targets = {}
    for name, root in (("here", _build.CSRC),
                       ("there", os.path.join(os.path.abspath(args.other),
                                              "embree_tpu_torch", "csrc"))):
        targets[name] = _build.Target(
            f"libtraverse_{name}.so",
            tuple(os.path.join(root, os.path.basename(u))
                  for u in base.units),
            tuple(os.path.join(root, os.path.basename(h))
                  for h in base.headers), base.flags, base.link)
        if os.path.exists(targets[name].path):   # build anew: its ptxas log
            os.remove(targets[name].path)
    secs = _build.build_all(list(targets), targets)
    print(f"built both libraries in {secs:.1f} s", flush=True)
    regs = ptxas_lines(_build.BUILD_LOGS["here"])
    regs_o = ptxas_lines(_build.BUILD_LOGS["there"])
    a, b = sass(targets["here"].path), sass(targets["there"].path)
    rows = []
    for k in sorted(set(a) | set(b)):
        state = ("only here" if k not in b else "only there" if k not in a
                 else "identical" if a[k] == b[k] else "differs")
        rows.append(dict(entry=k[0], flags=list(k[1]), sass=state,
                         here=regs.get(k), there=regs_o.get(k)))
        print(f"{k[0]} {k[1]}: {state}; here {regs.get(k)}, there "
              f"{regs_o.get(k)}", flush=True)
    counts = {s: sum(r["sass"] == s for r in rows)
              for s in ("identical", "differs", "only here", "only there")}
    print(f"SASS: {counts}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
