"""Bridge to the optional C++ NIfTI reader (`native/deepstaple_native.cpp`,
built into `native/libdeepstaple_io.so` by `native/build.sh`).

The counterpart of `deep_staple_tpu/data/native_io.py:26-165`, with the
port's own pure-Python reader (`data/nifti.py`) as the fallback:
`try_native_load` reads one volume, `try_native_load_batch` decodes many
on threads of the C++ runtime, both as float64 with nibabel's get_fdata
semantics. Where the library is missing but its source and build script
are there, it is built once (bounded; opt out with
DEEPSTAPLE_NO_AUTOBUILD=1); where it cannot be had, the reads are
sequential Python ones. A host library, not a kernel of the port.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from .nifti import load_nifti

_LIB = None
_LIB_SEARCHED = False
# The last autobuild failure (return code and the end of stderr), so that a
# broken toolchain can be told from a DEEPSTAPLE_NO_AUTOBUILD opt-out.
LAST_AUTOBUILD_ERROR: str | None = None


def _autobuild(native_dir: Path) -> None:
    """Build the shared library from the checked-in source, once, where it
    is missing (a fresh checkout has no .so: git ignores it). Bounded to 180
    s; a failure is kept in LAST_AUTOBUILD_ERROR and native/autobuild.log,
    and the Python reader still works. Opt out with DEEPSTAPLE_NO_AUTOBUILD=1.

    Concurrency-safe: builds serialize on an flock'd lockfile, compile to a
    per-pid temp name, and os.replace() into place (atomic on POSIX) so a
    concurrent process can never dlopen a partially written .so.
    """
    global LAST_AUTOBUILD_ERROR
    if os.environ.get("DEEPSTAPLE_NO_AUTOBUILD"):
        return
    build = native_dir / "build.sh"
    if not (build.is_file() and (native_dir / "deepstaple_native.cpp").is_file()):
        return
    target = native_dir / "libdeepstaple_io.so"
    tmp = native_dir / f".libdeepstaple_io.{os.getpid()}.so"
    lockfile = native_dir / ".autobuild.lock"
    try:
        import fcntl

        with open(lockfile, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if target.is_file():  # another process built it meanwhile
                return
            proc = subprocess.run(
                ["sh", str(build), str(tmp)], timeout=180, check=False,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            )
            if proc.returncode == 0 and tmp.is_file():
                os.replace(tmp, target)
            else:
                err = (proc.stderr or b"").decode(errors="replace")[-2000:]
                LAST_AUTOBUILD_ERROR = f"rc={proc.returncode}: {err}"
                try:
                    (native_dir / "autobuild.log").write_text(LAST_AUTOBUILD_ERROR)
                except OSError:
                    pass
    except (OSError, subprocess.TimeoutExpired) as exc:
        LAST_AUTOBUILD_ERROR = f"{type(exc).__name__}: {exc}"
    finally:
        tmp.unlink(missing_ok=True)


def _find_lib():
    global _LIB, _LIB_SEARCHED
    if _LIB_SEARCHED:
        return _LIB
    _LIB_SEARCHED = True
    here = Path(
        os.environ.get("DEEPSTAPLE_NATIVE_DIR")
        or Path(__file__).resolve().parent.parent.parent / "native"
    )
    candidates = [here / "libdeepstaple_io.so"]
    env_lib = os.environ.get("DEEPSTAPLE_IO_LIB")
    if env_lib:
        candidates.append(Path(env_lib))
    if not any(c.is_file() for c in candidates):
        _autobuild(here)
    for cand in candidates:
        if cand.is_file():
            try:
                lib = ctypes.CDLL(str(cand))
                lib.ds_load_nifti_f32.restype = ctypes.c_int
                lib.ds_load_nifti_f32.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_longlong),  # out dims[3]
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out buffer
                ]
                lib.ds_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
                if hasattr(lib, "ds_load_nifti_batch"):
                    lib.ds_load_nifti_batch.restype = ctypes.c_int
                    lib.ds_load_nifti_batch.argtypes = [
                        ctypes.POINTER(ctypes.c_char_p),
                        ctypes.c_int,
                        ctypes.c_int,
                        ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                        ctypes.POINTER(ctypes.c_int),
                    ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def reader_name() -> str:
    """The reader `try_native_load_batch` takes: "native" (the C++ batch
    reader) or "python" (sequential reads, the library absent)."""
    lib = _find_lib()
    return "native" if lib is not None and hasattr(lib, "ds_load_nifti_batch") else "python"


def try_native_load_batch(paths, n_threads: int | None = None) -> list[np.ndarray]:
    """Load many 3D NIfTI volumes, decoded in parallel by the C++ runtime
    (one decompression/convert thread per file up to n_threads). Falls back
    to sequential loads when the library is absent or lacks the batch entry
    point. Semantics per volume identical to `try_native_load`."""
    paths = [str(p) for p in paths]
    lib = _find_lib()
    if lib is None or not hasattr(lib, "ds_load_nifti_batch"):
        return [try_native_load(p) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    arr_t = ctypes.c_char_p * n
    c_paths = arr_t(*[p.encode() for p in paths])
    dims = (ctypes.c_longlong * (3 * n))()
    bufs = (ctypes.POINTER(ctypes.c_float) * n)()
    rcs = (ctypes.c_int * n)()
    lib.ds_load_nifti_batch(c_paths, n, int(n_threads), dims, bufs, rcs)
    out = []
    for i in range(n):
        if rcs[i] != 0:
            out.append(load_nifti(paths[i]).get_fdata())
            continue
        d = (dims[3 * i], dims[3 * i + 1], dims[3 * i + 2])
        cnt = d[0] * d[1] * d[2]
        arr = np.ctypeslib.as_array(bufs[i], shape=(cnt,)).copy()
        lib.ds_free(bufs[i])
        out.append(arr.reshape(d, order="F").astype(np.float64))
    return out


def try_native_load(path) -> np.ndarray:
    """Load a 3D NIfTI volume as float64 (nibabel get_fdata semantics)."""
    lib = _find_lib()
    if lib is not None:
        dims = (ctypes.c_longlong * 3)()
        buf = ctypes.POINTER(ctypes.c_float)()
        rc = lib.ds_load_nifti_f32(str(path).encode(), dims, ctypes.byref(buf))
        if rc == 0:
            n = dims[0] * dims[1] * dims[2]
            arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
            lib.ds_free(buf)
            # C++ loader emits C-order (row-major) over (d0, d1, d2) with d0
            # fastest (Fortran voxel order), matching the Python reader.
            return arr.reshape((dims[0], dims[1], dims[2]), order="F").astype(np.float64)
    return load_nifti(path).get_fdata()
