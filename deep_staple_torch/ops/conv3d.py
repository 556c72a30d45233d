"""Depthwise 3x3x3 convolution as 27 shifted multiply-adds, with the JAX
package's hand-written backward, in plain PyTorch.

The counterpart of `deep_staple_tpu/ops/conv3d.py:33-109`
(`depthwise_conv3d_shifted`, JAX's default `impl="shift"` depthwise path,
`models/lraspp3d.py:104-114`): x (B, D, H, W, C), kernel in Flax's layout
(3, 3, 3, 1, C), 'same' padding 1, stride 1 or 2, taps accumulated in
float32 (float64 for float64 inputs), output in x's dtype. The backward is
JAX's custom VJP: the input gradient is the flipped taps over the cotangent
dilated back to the input lattice, the weight gradient one sum a tap in
float32, cast to the kernel's dtype.

It computes with `ops/conv3d_dw.py`'s plain versions on any device. The
port's model runs the Hopper kernels K2 and K3 on the card
(`ops/conv3d_dw.py::depthwise_conv3d`); this module is their plain
counterpart in JAX's layout, not a second path on the card.
"""

from __future__ import annotations

import torch

from .conv3d_dw import (
    depthwise_conv3d_grad_w_plain,
    depthwise_conv3d_grad_x_plain,
    depthwise_conv3d_plain,
)


def _taps27(kernel):
    if tuple(kernel.shape[:4]) != (3, 3, 3, 1):
        raise ValueError(f"kernel must be (3, 3, 3, 1, C), got {tuple(kernel.shape)}")
    return kernel.reshape(27, kernel.shape[-1])  # tap index dz*9 + dy*3 + dx


class _DepthwiseShifted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, kernel)
        return depthwise_conv3d_plain(x, _taps27(kernel), stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = depthwise_conv3d_grad_x_plain(g, _taps27(kernel), ctx.stride, x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = depthwise_conv3d_grad_w_plain(x, g, ctx.stride).reshape(kernel.shape).to(kernel.dtype)
        return gx, gw, None


def depthwise_conv3d_shifted(x, kernel, stride: int = 1):
    """x: (B, D, H, W, C); kernel: (3, 3, 3, 1, C) -> (B, ceil(D/stride),
    ceil(H/stride), ceil(W/stride), C). Differentiable in x and kernel."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    return _DepthwiseShifted.apply(x, kernel, stride)
