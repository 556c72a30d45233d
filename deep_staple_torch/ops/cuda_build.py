"""Build and load the port's CUDA kernels (`deep_staple_torch/csrc/*.cu`).

Each source compiles with nvcc for `sm_90a` into its own shared library with
a plain C interface under `build/kernels/`, named by a digest of the source
and the flags, so a changed source builds again and an unchanged one is
reused. `build_libraries` starts one nvcc for each source that needs it, all
at once, and waits for them; `load` builds one source if needed and opens it
with ctypes. Nothing here runs when a module is imported: the CPU tests
import every module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("depthwise_conv3d", "sep_warp_pass", "staple_em")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_libraries(names=SOURCES, verbose: bool = False) -> dict:
    """Compile each source of `names` unless a build of that exact source
    exists; `verbose` always compiles, with ptxas's register and spill
    report. The nvcc processes run in parallel. Returns {name: (path of the
    shared library, compiler messages)}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        so = library_path(name)
        if so.is_file() and not verbose:
            out[name] = (so, "")
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        messages, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}:\n{messages}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees the old or the new file
        out[name] = (so, messages)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        so, _ = build_libraries((name,))[name]
        _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.error_string(err).decode()}")
