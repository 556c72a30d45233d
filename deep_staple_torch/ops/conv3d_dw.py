"""Depthwise 3x3x3 convolution, forward: the Hopper kernel and its plain version.

The counterpart of `deep_staple_tpu/ops/conv3d_pallas.py` (the Pallas
stencil `_fwd_kernel`, stride 1) and, for stride 2, of
`deep_staple_tpu/ops/conv3d.py:63-70`. One function, 'same' padding of 1
with zeros at every border, NDHWC layout, weights (27, C) in float32 with tap
index dz*9 + dy*3 + dx, the 27 taps accumulated in float32, output in the
input dtype, output extent ceil(n / stride).

  * `depthwise_conv3d_plain` is the plain PyTorch version: 27 shifted
    multiply-adds in float32.
  * `depthwise_conv3d` is the wrapper. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel of `csrc/depthwise_conv3d.cu` or
    raises. `depthwise_conv3d.launches` counts the kernel launches.
  * `load_library` builds the kernel with nvcc on first CUDA use (and again
    when the source changes) into `build/kernels/` and loads it with ctypes.

Forward only: the backward (flipped-tap grad_x and the (27, C) weight
gradient) comes with the training slice, so a CUDA input that needs a
gradient raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "depthwise_conv3d.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(verbose: bool = False) -> tuple[Path, str]:
    """Compile `csrc/depthwise_conv3d.cu` unless a build of this exact source
    exists; `verbose` always compiles, with ptxas's register and spill report.
    Returns (path of the shared library, compiler messages)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libdepthwise_conv3d_{digest}.so"
    if so.is_file() and not verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees the old or the new file
    return so, proc.stdout + proc.stderr


def load_library():
    global _lib
    if _lib is None:
        so, _ = build_library()
        lib = ctypes.CDLL(str(so))
        lib.dw3d_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.dw3d_fwd.restype = ctypes.c_int
        lib.dw3d_error_string.argtypes = [ctypes.c_int]
        lib.dw3d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def out_extent(n: int, stride: int) -> int:
    return -(-n // stride)


def depthwise_conv3d_plain(x, w27, stride: int = 1):
    """x: (B, D, H, W, C); w27: (27, C) float32 -> (B, ceil(D/s), ceil(H/s),
    ceil(W/s), C) in x's dtype, as 27 shifted multiply-adds in float32."""
    B, D, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    w = w27.float()
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                sl = xp[:, dz : dz + D : stride, dy : dy + H : stride, dx : dx + W : stride, :]
                term = sl * w[dz * 9 + dy * 3 + dx]
                acc = term if acc is None else acc.add_(term)
    return acc.to(x.dtype)


def _check_cuda_args(x, kernel, stride: int):
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NDHWC")
    if kernel.device != x.device or x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"x ({x.device}) and kernel ({kernel.device}) must lie on the current "
            f"CUDA device (cuda:{torch.cuda.current_device()})"
        )
    if kernel.dtype != torch.float32 or tuple(kernel.shape) != (27, C) or not kernel.is_contiguous():
        raise ValueError(
            f"kernel must be contiguous float32 (27, {C}), got {kernel.dtype} {tuple(kernel.shape)}"
        )
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise NotImplementedError(
            "the CUDA depthwise kernel is forward only; run under torch.no_grad() "
            "or torch.inference_mode() (the backward comes with the training slice)"
        )
    if max(x.shape) >= 2**31:
        raise ValueError(f"extent too large for the kernel: {tuple(x.shape)}")


def depthwise_conv3d(x, kernel, stride: int = 1):
    """Depthwise 3x3x3 conv, 'same' padding, NDHWC; kernel (27, C) float32.

    CPU tensors take `depthwise_conv3d_plain`. CUDA tensors launch the
    Hopper kernel on the current stream, without synchronising, and add one
    to `depthwise_conv3d.launches`.
    """
    if x.device.type == "cpu":
        return depthwise_conv3d_plain(x, kernel, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, kernel, stride)
    lib = load_library()
    B, D, H, W, C = x.shape
    y = torch.empty(
        (B, out_extent(D, stride), out_extent(H, stride), out_extent(W, stride), C),
        dtype=x.dtype, device=x.device,
    )
    err = lib.dw3d_fwd(
        x.data_ptr(), kernel.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.bfloat16), stride, B, D, H, W, C,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"depthwise_conv3d kernel launch failed: {lib.dw3d_error_string(err).decode()}"
        )
    depthwise_conv3d.launches += 1
    return y


depthwise_conv3d.launches = 0
