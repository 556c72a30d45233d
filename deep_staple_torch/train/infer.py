"""Single-volume inference (`deep_staple_tpu/train/infer.py`, after
`inference_wrap`, `main_deep_staple.py:471-487`): one volume, or one slice
for the 2D model, through the model in eval mode, optionally as its MIND-SSC
features, argmax to a label map, on the model's device. A model sharded over
a model axis (`parallel/tensor.py`) sums its row convs over its group, so
every rank of the group calls it on the same volume. For whole-volume
inference over a space axis of ranks see
`parallel.spatial.make_whole_volume_inference`."""

from __future__ import annotations

import torch

from .step import _featurize


def make_inference_fn(model, use_mind: bool = False, use_2d: bool = False):
    """-> infer(img): a (*spatial,) volume or slice (numpy or tensor) ->
    (*spatial,) int32 labels on the model's device."""
    device = next(model.parameters()).device

    def infer(img):
        x = torch.as_tensor(img, dtype=torch.float32).to(device)
        with torch.inference_mode():
            out = model(_featurize(x[None], use_mind, use_2d), train=False)["out"]
        return out.argmax(dim=-1)[0].to(torch.int32)

    return infer


def inference_wrap(model, state, img, use_mind: bool = False, use_2d: bool = False):
    """`model` holds the weights (the state's model, `state.model`); `state`
    is taken for the JAX signature."""
    return make_inference_fn(model, use_mind, use_2d)(img)
