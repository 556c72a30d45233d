"""Device resolution for the port's entry points.

The default device is `cuda`. Without CUDA the default raises: an entry
point never drops to the CPU quietly. The CPU runs only when the caller asks
for it (`device="cpu"`, `--device cpu`), as the tests do.
"""

from __future__ import annotations

import torch


def set_f32_precision() -> None:
    """Full float32 on the card: no TF32 in cuDNN convolutions or in matmuls.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference computes them in float32.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """`None` or "cuda" -> the current CUDA device (raises without CUDA);
    "cpu" -> the CPU; any other string or `torch.device` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_f32_precision()
    return dev
