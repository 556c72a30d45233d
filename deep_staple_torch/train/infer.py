"""Single-volume inference (`deep_staple_tpu/train/infer.py`, after
`inference_wrap`, `main_deep_staple.py:471-487`): one volume through the
model in eval mode, argmax to a label map, on the model's device."""

from __future__ import annotations

import torch


def make_inference_fn(model, use_mind: bool = False, use_2d: bool = False):
    """-> infer(img): a (*spatial,) volume (numpy or tensor) -> (*spatial,)
    int32 labels on the model's device."""
    if use_mind or use_2d:
        raise NotImplementedError("MIND features and the 2D model come with slice 5 of the port")
    device = next(model.parameters()).device

    def infer(img):
        x = torch.as_tensor(img, dtype=torch.float32).to(device)
        with torch.inference_mode():
            out = model(x[None, ..., None], train=False)["out"]
        return out.argmax(dim=-1)[0].to(torch.int32)

    return infer


def inference_wrap(model, state, img, use_mind: bool = False, use_2d: bool = False):
    """`model` holds the weights (the state's model, `state.model`); `state`
    is taken for the JAX signature."""
    return make_inference_fn(model, use_mind, use_2d)(img)
