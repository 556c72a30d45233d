"""ctypes binding to the C++ STAPLE EM (`native/deepstaple_native.cpp::ds_staple_em`).

The port's own binding, for the consensus CLI's `--native`: a CPU
cross-check of the EM in double precision, the role SimpleITK's C++ filter
played for the reference. The library is built by `native/build.sh`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

LIBRARY = Path(__file__).resolve().parents[2] / "native" / "libdeepstaple_io.so"
_LIB = None


def _lib():
    global _LIB
    if _LIB is None and LIBRARY.is_file():
        lib = ctypes.CDLL(str(LIBRARY))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ds_staple_em.restype = ctypes.c_int
        lib.ds_staple_em.argtypes = [f32p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double,
                                     ctypes.c_int, ctypes.c_double, f32p, f32p, f32p]
        _LIB = lib
    return _LIB


def native_staple_available() -> bool:
    return _lib() is not None


def staple_consensus_native(label_list, max_iterations: int = 200, epsilon: float = 1e-7,
                            confidence_weight: float = 1.0, threshold: float = 0.5):
    """-> (consensus int32 array (*spatial), sensitivities, specificities,
    iterations), all on the host."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native STAPLE library not built: {LIBRARY} (run native/build.sh)")
    stack = np.stack([np.asarray(lbl) for lbl in label_list]).astype(np.float32)
    spatial = stack.shape[1:]
    R = stack.shape[0]
    d = np.ascontiguousarray(stack.reshape(R, -1))
    V = d.shape[1]
    w = np.zeros(V, np.float32)
    p = np.zeros(R, np.float32)
    q = np.zeros(R, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    iters = lib.ds_staple_em(d.ctypes.data_as(f32p), R, V, confidence_weight, max_iterations,
                             epsilon, w.ctypes.data_as(f32p), p.ctypes.data_as(f32p),
                             q.ctypes.data_as(f32p))
    if iters < 0:
        raise RuntimeError(f"native STAPLE failed with code {iters}")
    return (w > threshold).astype(np.int32).reshape(spatial), p, q, iters
