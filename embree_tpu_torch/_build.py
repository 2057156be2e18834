"""Build the port's native code at first use.

Shared libraries, each with a plain C interface loaded through ctypes:

- ``traverse_cuda``: the Hopper traversal kernel, built with ``nvcc`` for
  ``sm_90a`` (only where a CUDA toolkit exists): ``csrc/traverse.cu``
  (scenes without curves, and the entry point), ``csrc/traverse_curves.cu``
  (scenes with flat curves only) and ``csrc/traverse_round.cu`` (scenes
  with round curves) compile to objects in parallel, one process each, and
  link into one library;
- ``bvh_builder``: the OpenMP binned-SAH BVH8 builder,
  ``native/bvh_builder.cpp``, built with ``g++``;
- ``traverse_twin``: the kernel's per-ray logic (``csrc/traverse.cuh``)
  compiled for the host with ``g++``. Tests use it to check the kernel's
  arithmetic where there is no GPU; it is never on the main path;
- ``ablate_cuda``: the two traversal ablation kernels of ``perf/``
  (``csrc/ablate_v7.cu``, ``csrc/ablate_v5.cu``, compiled in parallel and
  linked into one library), and ``ablate_twin``, their walk and scheduler
  (``csrc/ablate.cuh``) compiled for the host for the tests;
- ``micro_cuda``: the three loop-probe kernels of ``perf/``
  (``csrc/micro_ops.cu``, ``csrc/micro_expand.cu``, ``csrc/micro_v8.cu``
  over ``csrc/micro.cuh``, compiled in parallel and linked into one
  library), and ``micro_twin``, the probes of all three compiled for the
  host for the tests (``csrc/micro_cpu.cpp``).

Every library goes into one build directory inside the package (``_build/``,
listed in ``.gitignore``) and is rebuilt when it is missing or older than one
of its sources. A build writes to a private temporary name and renames it
into place, so processes that build at the same time never load a partial
file. The compiler's output goes beside the library (``<library>.log``),
so a process that finds the library up to date still reads its ptxas
lines (``BUILD_LOGS``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC = os.path.join(PKG_DIR, "csrc")
NATIVE = os.path.join(PKG_DIR, "native")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


@dataclasses.dataclass(frozen=True)
class Target:
    lib: str                    # output file name inside BUILD_DIR
    units: Tuple[str, ...]      # compiled one process each
    headers: Tuple[str, ...]    # further dependencies
    flags: Tuple[str, ...]      # compiler flags (the compiler comes first)
    # several units: each is compiled with ``flags -c``, then the objects
    # are linked with ``link``; one unit is compiled straight to the library
    link: Tuple[str, ...] = ()

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, self.lib)

    @property
    def sources(self) -> Tuple[str, ...]:
        return self.units + self.headers


def _targets() -> Dict[str, Target]:
    cuh = os.path.join(CSRC, "traverse.cuh")
    launch = os.path.join(CSRC, "launch.cuh")
    # --fmad=false: no a*b+c contraction, so t bits equal the plain PyTorch
    # version's (and the JAX package's) separate mul and add
    arch = ("-gencode", "arch=compute_90a,code=sm_90a")
    return {
        "traverse_cuda": Target(
            "libtraverse_cuda.so",
            (os.path.join(CSRC, "traverse.cu"),
             os.path.join(CSRC, "traverse_curves.cu"),
             os.path.join(CSRC, "traverse_round.cu")), (launch, cuh),
            (_nvcc(),) + arch + ("-std=c++17", "-O3", "--fmad=false",
                                 "-Xptxas", "-v", "-Xcompiler", "-fPIC"),
            link=(_nvcc(),) + arch + ("-shared",)),
        # the two traversal ablations (perf/), one library
        "ablate_cuda": Target(
            "libablate_cuda.so",
            (os.path.join(CSRC, "ablate_v7.cu"),
             os.path.join(CSRC, "ablate_v5.cu")),
            (os.path.join(CSRC, "ablate.cuh"), launch, cuh),
            (_nvcc(),) + arch + ("-std=c++17", "-O3", "--fmad=false",
                                 "-Xptxas", "-v", "-Xcompiler", "-fPIC"),
            link=(_nvcc(),) + arch + ("-shared",)),
        # the three loop probes (perf/), one library
        "micro_cuda": Target(
            "libmicro_cuda.so",
            tuple(os.path.join(CSRC, f"micro_{u}.cu")
                  for u in ("ops", "expand", "v8")),
            (os.path.join(CSRC, "micro.cuh"),),
            (_nvcc(),) + arch + ("-std=c++17", "-O3", "--fmad=false",
                                 "-Xptxas", "-v", "-Xcompiler", "-fPIC"),
            link=(_nvcc(),) + arch + ("-shared",)),
        # the same flags as the JAX package's copy of the builder, so both
        # build the same tree from the same bounds
        "bvh_builder": Target(
            "libbvh.so", (os.path.join(NATIVE, "bvh_builder.cpp"),), (),
            ("g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")),
        # no -march=native: that would allow FMA; -ffp-contract=off forbids
        # contraction like --fmad=false does on the card
        "traverse_twin": Target(
            "libtraverse_twin.so", (os.path.join(CSRC, "traverse_cpu.cpp"),),
            (cuh,), ("g++", "-O2", "-std=c++17", "-ffp-contract=off",
                     "-shared", "-fPIC")),
        "ablate_twin": Target(
            "libablate_twin.so", (os.path.join(CSRC, "ablate_cpu.cpp"),),
            (os.path.join(CSRC, "ablate.cuh"), cuh),
            ("g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
             "-fPIC")),
        "micro_twin": Target(
            "libmicro_twin.so", (os.path.join(CSRC, "micro_cpu.cpp"),),
            tuple(os.path.join(CSRC, f) for f in
                  ("micro.cuh", "micro_ops.cu", "micro_expand.cu",
                   "micro_v8.cu")),
            ("g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
             "-fPIC")),
    }


TARGETS = _targets()
# compiler output of the last build of each target (ptxas register and spill
# lines for the CUDA kernel)
BUILD_LOGS: Dict[str, str] = {}
_lock = threading.Lock()


def _log_path(t: Target) -> str:
    return t.path + ".log"


def _cached_log(name: str, t: Target) -> None:
    """The compiler output of an up-to-date library, kept beside it when it
    was built, so that a later process reads the same ptxas lines."""
    if os.path.exists(_log_path(t)):
        with open(_log_path(t)) as f:
            BUILD_LOGS[name] = f.read()


def _stale(t: Target) -> bool:
    if not os.path.exists(t.path):
        return True
    built = os.path.getmtime(t.path)
    return any(os.path.getmtime(s) > built for s in t.sources)


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(t: Target):
    """Start compiling one target's units, all at once; returns (the
    processes, their outputs, the library's temporary path) or None when
    the library is up to date."""
    if not _stale(t):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{t.path}.{os.getpid()}.{threading.get_ident()}.tmp"
    if not t.link:
        return [_run(list(t.flags) + [t.units[0], "-o", tmp])], [tmp], tmp
    objs = [f"{tmp}.{k}.o" for k in range(len(t.units))]
    procs = [_run(list(t.flags) + ["-c", u, "-o", o])
             for u, o in zip(t.units, objs)]
    return procs, objs, tmp


def _finish(name: str, t: Target, started) -> None:
    procs, outs, tmp = started
    logs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if t.link and not any(codes):
        proc = _run(list(t.link) + outs + ["-o", tmp])
        logs.append(proc.communicate()[0])
        codes.append(proc.returncode)
    log = "".join(logs)
    BUILD_LOGS[name] = log
    for f in set(outs) - {tmp}:
        if os.path.exists(f):
            os.remove(f)
    if any(codes):
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {name} failed (exit "
                           f"{max(codes)}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", _log_path(t))
    os.replace(tmp, t.path)


def ensure(name: str) -> str:
    """Path of the named library, built first if needed."""
    with _lock:
        started = _start(TARGETS[name])
        if started is None:
            _cached_log(name, TARGETS[name])
        else:
            _finish(name, TARGETS[name], started)
    return TARGETS[name].path


def build_all(names: Iterable[str],
              targets: Optional[Dict[str, Target]] = None) -> float:
    """Build the named libraries of ``targets`` (default ``TARGETS``) in
    parallel, one compiler process per unit. Returns the wall seconds
    spent."""
    targets = TARGETS if targets is None else targets
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(targets[n]) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                _cached_log(n, targets[n])
                continue
            try:
                _finish(n, targets[n], s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0
