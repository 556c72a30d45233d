"""The library's convolution kernels, named as the card's trace names them,
for the readers of the dense convolutions' time.

cuDNN runs `PlainConvUNet`'s dense 3x3x3 convs, transposed convs and 1x1x1
heads as implicit GEMMs whose names give the pass ("fprop": a forward, or a
transposed conv's input gradient; "dgrad": an input gradient, or a
transposed conv's forward; "wgrad": a weight gradient), as CUTLASS GEMMs
("...gemm_bf16...": the 1x1x1 heads) and, for the one-channel input conv,
as its generic `implicit_convolveNd_sgemm`. Read off `torch.profiler`'s
kernel names of `train-nnunet-b8` on the H100 (torch 2.11+cu128, cuDNN
9.2): "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_...",
"sm90_xmma_dgrad_implicit_gemm_...", "sm90_xmma_wgrad_indexed_implicit_gemm_...",
"cutlass_80_wmma_tensorop_s161616gemm_bf16_...". cuDNN's layout and
padding kernels ("nchwToNhwcKernel", "nhwcAddPaddingKernel") are not
convolution. That cell's step runs no other GEMM, so "gemm" names its
convolutions alone.
"""

from __future__ import annotations

CONV_KERNELS = ("fprop", "dgrad", "wgrad", "gemm", "convolveNd")


def is_conv(name: str) -> bool:
    return any(p in name for p in CONV_KERNELS)


def conv_seconds(kernels: dict) -> float:
    return sum(s for name, s in kernels.items() if is_conv(name))
