"""Build and load the port's CUDA kernels.

Each source in `splendax_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into its own shared library with a plain C interface, under `build/kernels/`
at the root of the checkout, and loaded with `ctypes`.  A library is built
on first use, or again when its source, a header of `csrc/` or a generated
header is newer.  `build` starts one `nvcc` per source, all at once
(`compile_many`).  The generated header, `engine_tables.h` (the card and
noble tables, `ops/engine_tables`), is written into `build/kernels/`, which
is on nvcc's include path, before any compile.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("fused_actor_critic_wgmma", "ring_take", "engine_ply")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _write_headers() -> None:
    from . import engine_tables

    engine_tables.write(BUILD_DIR)


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    _write_headers()
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh"), BUILD_DIR / "engine_tables.h"]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def compile_many(jobs: dict) -> dict:
    """One nvcc per job, all started at once.  `jobs` maps a name to
    (source .cu, output .so, extra nvcc flags).  Returns {name: nvcc's
    output, the ptxas report}; raises with the output of every nvcc that
    failed."""
    nvcc = _nvcc()
    _write_headers()
    procs = {
        n: subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(BUILD_DIR), *flags, "-o", str(out),
                             str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, (src, out, flags) in jobs.items()
    }
    reports, failed = {}, []
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode})\n{out}")
        reports[n] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named kernels in parallel.  Returns {name: ptxas report}
    for each library it built; raises with nvcc's output if any fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = {n: BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp" for n in todo}
    reports = compile_many({n: (CSRC / f"{n}.cu", tmp[n], ()) for n in todo})
    for n in todo:
        os.replace(tmp[n], _lib_path(n))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def timed_build(names=SOURCES) -> tuple[float, dict]:
    """Force a fresh parallel build; returns (seconds, ptxas reports)."""
    t0 = time.perf_counter()
    reports = build(names, force=True)
    return time.perf_counter() - t0, reports
