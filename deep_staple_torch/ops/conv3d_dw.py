"""Depthwise 3x3x3 convolution with its backward: the Hopper kernels and their
plain versions.

The counterpart of `deep_staple_tpu/ops/conv3d_pallas.py` (the Pallas
stencil `_fwd_kernel`, its flipped-tap use for grad_x and `_gw_kernel` for
the weight gradient, `:244-272`) and, for stride 2, of the custom VJP in
`deep_staple_tpu/ops/conv3d.py:62-109`. One function, 'same' padding of 1
with zeros at every border, NDHWC layout, weights (27, C) in float32 with tap
index dz*9 + dy*3 + dx, the taps accumulated in float32, output in the input
dtype, output extent ceil(n / stride).

  * `depthwise_conv3d` is differentiable (`torch.autograd.Function`): the
    input gradient comes back in x's dtype and the weight gradient in
    float32 (27, C). A bfloat16 model casts its weights to bfloat16 before
    the call (`models/lraspp3d.py`), so their gradient goes back through
    that cast, as in JAX.
  * Three wrappers, each with a plain PyTorch version beside it and a launch
    counter (`.launches`): `depthwise_conv3d_fwd`, `depthwise_conv3d_grad_x`
    and `depthwise_conv3d_grad_w`. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel of `csrc/depthwise_conv3d.cu` or raises.
  * The kernels build with nvcc on first CUDA use (`ops/cuda_build.py`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def load_library():
    lib = cuda_build.load("depthwise_conv3d")
    if not hasattr(lib, "error_string"):
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args, res in (
            (lib.dw3d_fwd, [vp, vp, vp, i, i, i, i, i, i, i, vp], i),
            (lib.dw3d_grad_x, [vp, vp, vp, i, i, i, i, i, i, i, vp], i),
            (lib.dw3d_grad_w_workspace, [i, i, i, i, i, i, i], i64),
            (lib.dw3d_grad_w, [vp, vp, vp, i64, vp, i, i, i, i, i, i, i, vp], i),
        ):
            fn.argtypes = args
            fn.restype = res
        lib.dw3d_error_string.argtypes = [ctypes.c_int]
        lib.dw3d_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.dw3d_error_string
    return lib


def out_extent(n: int, stride: int) -> int:
    return -(-n // stride)


def _taps(xp, D: int, H: int, W: int, stride: int):
    """The 27 shifted views of the padded xp, in tap order dz*9 + dy*3 + dx."""
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                yield xp[:, dz : dz + D : stride, dy : dy + H : stride, dx : dx + W : stride, :]


def _pad1(x):
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def _acc_dtype(x):
    """float32 accumulation, or float64 for float64 inputs (as
    conv3d.py:44's promote_types)."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise_conv3d_plain(x, w27, stride: int = 1):
    """x: (B, D, H, W, C); w27: (27, C) float32 -> (B, ceil(D/s), ceil(H/s),
    ceil(W/s), C) in x's dtype, as 27 shifted multiply-adds in float32."""
    _, D, H, W, _ = x.shape
    acc_t = _acc_dtype(x)
    w = w27.to(acc_t)
    acc = None
    for t, sl in enumerate(_taps(_pad1(x.to(acc_t)), D, H, W, stride)):
        term = sl * w[t]
        acc = term if acc is None else acc.add_(term)
    return acc.to(x.dtype)


def depthwise_conv3d_grad_x_plain(g, w27, stride: int, in_shape):
    """The input gradient: g (B, ceil(D/s), ceil(H/s), ceil(W/s), C), the
    cotangent of the output -> (B, D, H, W, C) = in_shape, in g's dtype.
    The stride-2 form dilates g back to the input lattice, as
    conv3d.py:83-90 does, then applies the flipped taps."""
    B, D, H, W, C = in_shape
    gf = g.to(_acc_dtype(g))
    if stride != 1:
        gd = gf.new_zeros((B, D, H, W, C))
        gd[:, ::stride, ::stride, ::stride] = gf
        gf = gd
    return depthwise_conv3d_plain(gf, w27.flip(0), 1).to(g.dtype)


def depthwise_conv3d_grad_w_plain(x, g, stride: int):
    """The weight gradient (27, C) float32 (float64 for float64 inputs): per
    tap, the sum over batch and output positions of the shifted input times
    g, in float32."""
    _, D, H, W, C = x.shape
    acc_t = _acc_dtype(x)
    gf = g.to(acc_t)
    return torch.stack([
        (sl * gf).reshape(-1, C).sum(0) for sl in _taps(_pad1(x.to(acc_t)), D, H, W, stride)
    ])


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
    if max(x.shape) >= 2**31:
        raise ValueError(f"extent too large for the kernel: {tuple(x.shape)}")


def _on_cuda(x) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def depthwise_conv3d_fwd(x, kernel, stride: int = 1):
    """The forward: CPU tensors take `depthwise_conv3d_plain`; CUDA tensors
    launch the Hopper kernel on the current stream, without synchronising,
    and add one to `depthwise_conv3d_fwd.launches`."""
    if not _on_cuda(x):
        return depthwise_conv3d_plain(x, kernel, stride)
    _check_cuda_args(x, kernel, stride)
    lib = load_library()
    B, D, H, W, C = x.shape
    y = torch.empty(
        (B, out_extent(D, stride), out_extent(H, stride), out_extent(W, stride), C),
        dtype=x.dtype, device=x.device,
    )
    err = lib.dw3d_fwd(x.data_ptr(), kernel.data_ptr(), y.data_ptr(),
                       int(x.dtype == torch.bfloat16), stride, B, D, H, W, C, _stream(x))
    cuda_build.check(lib, err, "depthwise_conv3d_fwd")
    depthwise_conv3d_fwd.launches += 1
    return y


def depthwise_conv3d_grad_x(g, kernel, stride: int, in_shape):
    """The input gradient of the forward at input shape `in_shape`, in g's
    dtype: `depthwise_conv3d_grad_x_plain` on the CPU, the kernel on CUDA
    (counted in `depthwise_conv3d_grad_x.launches`)."""
    in_shape = tuple(int(n) for n in in_shape)
    if not _on_cuda(g):
        return depthwise_conv3d_grad_x_plain(g, kernel, stride, in_shape)
    _check_cuda_args(g, kernel, stride)
    B, D, H, W, C = in_shape
    if tuple(g.shape) != (B, out_extent(D, stride), out_extent(H, stride), out_extent(W, stride), C):
        raise ValueError(f"g {tuple(g.shape)} is not the output of input {in_shape} at stride {stride}")
    lib = load_library()
    gx = torch.empty(in_shape, dtype=g.dtype, device=g.device)
    err = lib.dw3d_grad_x(g.data_ptr(), kernel.data_ptr(), gx.data_ptr(),
                          int(g.dtype == torch.bfloat16), stride, B, D, H, W, C, _stream(g))
    cuda_build.check(lib, err, "depthwise_conv3d_grad_x")
    depthwise_conv3d_grad_x.launches += 1
    return gx


def depthwise_conv3d_grad_w(x, g, stride: int):
    """The weight gradient (27, C) float32: `depthwise_conv3d_grad_w_plain`
    on the CPU, the two-pass kernel on CUDA (counted in
    `depthwise_conv3d_grad_w.launches`) with a scratch of per-block partial
    sums; its sum has a fixed order, so the result repeats bit for bit."""
    if not _on_cuda(x):
        return depthwise_conv3d_grad_w_plain(x, g, stride)
    B, D, H, W, C = x.shape
    _check_cuda_args(x, torch.empty(27, C, device=x.device), stride)
    want = (B, out_extent(D, stride), out_extent(H, stride), out_extent(W, stride), C)
    if tuple(g.shape) != want or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be contiguous {x.dtype} {want} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    gw = torch.empty((27, C), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return gw.zero_()
    lib = load_library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    n_work = lib.dw3d_grad_w_workspace(is_bf16, stride, B, D, H, W, C)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    err = lib.dw3d_grad_w(x.data_ptr(), g.data_ptr(), work.data_ptr(), n_work, gw.data_ptr(),
                          is_bf16, stride, B, D, H, W, C, _stream(x))
    cuda_build.check(lib, err, "depthwise_conv3d_grad_w")
    depthwise_conv3d_grad_w.launches += 1
    return gw


depthwise_conv3d_fwd.launches = 0
depthwise_conv3d_grad_x.launches = 0
depthwise_conv3d_grad_w.launches = 0


class _DepthwiseConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, kernel)
        return depthwise_conv3d_fwd(x, kernel, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = depthwise_conv3d_grad_x(gy, kernel, ctx.stride, x.shape)
        if ctx.needs_input_grad[1]:
            gw = depthwise_conv3d_grad_w(x, gy, ctx.stride)
        return gx, gw, None


def depthwise_conv3d(x, kernel, stride: int = 1):
    """Depthwise 3x3x3 conv, 'same' padding, NDHWC; kernel (27, C) float32.
    Differentiable in x and kernel; without a gradient to track it is
    `depthwise_conv3d_fwd`."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return _DepthwiseConv3d.apply(x, kernel, stride)
    return depthwise_conv3d_fwd(x, kernel, stride)
