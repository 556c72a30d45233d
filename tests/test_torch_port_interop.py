"""Reference-layout state dicts into the port's models and back
(`models/torch_interop.py`), against the reference-layout PyTorch models of
`benchmarks/` and the JAX package's bridge, on the CPU.

3D: `benchmarks.torch_reference_step.TorchLRASPP3D` has the reference's
`MobileNet_LRASPP_3D` key layout; 2D: `benchmarks.torch_reference_2d.
TorchLRASPP2D` has torchvision's `lraspp_mobilenet_v3_large` layout. Each
model's BatchNorm statistics are moved away from (0, 1) by two train-mode
forwards; its state dict goes into the port's model (and, through
`deep_staple_tpu/models/torch_interop.py`, into JAX's), and the eval logits
of the same input are compared, as `tests/test_torch_parity.py` and
`tests/test_torch_parity_2d.py` compare the reference models with JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_staple_torch.models import torch_interop as ti

torch.set_num_threads(1)

SPATIAL = (24, 24, 16)
HW = (40, 48)


def _advanced(model, shape):
    """Two train-mode forwards (statistics away from their init), then eval."""
    model.train()
    with torch.no_grad():
        for i in range(2):
            model(torch.randn(2, 1, *shape, generator=torch.Generator().manual_seed(i)))
    return model.eval()


@pytest.fixture(scope="module")
def reference_3d():
    from benchmarks.torch_reference_step import TorchLRASPP3D

    torch.manual_seed(0)
    tm = TorchLRASPP3D()
    tm.aspp.project[3].p = 0.0  # no dropout
    return _advanced(tm, SPATIAL)


@pytest.fixture(scope="module")
def reference_2d():
    from benchmarks.torch_reference_2d import TorchLRASPP2D

    torch.manual_seed(0)
    return _advanced(TorchLRASPP2D(in_channels=1, num_classes=2), HW)


@pytest.mark.parametrize("bn_mode", ["batch", "async"])
def test_reference_3d_state_dict_gives_its_logits_and_jax(reference_3d, bn_mode):
    """The port's model with the reference's state dict: eval logits within
    1e-4 relative / 2e-5 absolute of the reference model's (the tolerance of
    `tests/test_torch_parity.py`, float32 convolutions in other orders) and
    of JAX's model loaded by JAX's bridge. An 'async' model keeps its
    BatchNorm counts (the reference layout has none)."""
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.models.torch_interop import torch_state_dict_to_flax
    from deep_staple_torch.models import MobileNetLRASPP3D

    x = np.random.RandomState(1).randn(2, *SPATIAL).astype(np.float32)
    with torch.no_grad():
        want = reference_3d(torch.from_numpy(x)[:, None]).numpy()  # (B, C, D, H, W)
    model = MobileNetLRASPP3D(num_classes=2, dropout_rate=0.0, bn_mode=bn_mode)
    ti.load_reference_state_dict(model, reference_3d.state_dict())
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)[..., None])["out"].numpy()
    got = np.moveaxis(got, -1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    variables = torch_state_dict_to_flax(reference_3d.state_dict())
    jax_out = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0).apply(
        variables, jnp.asarray(x)[..., None], train=False)["out"]
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(jax_out), -1, 1), rtol=1e-4, atol=2e-5)
    if bn_mode == "async":
        assert all(int(v) == 0 for k, v in model.state_dict().items() if k.endswith(".count"))


def test_reference_3d_round_trip(reference_3d):
    """Reference -> port -> reference gives every tensor of the reference
    layout back exactly (the aliases and num_batches_tracked aside), as JAX's
    bridge does."""
    from deep_staple_tpu.models.torch_interop import (
        flax_variables_to_torch_state_dict,
        torch_state_dict_to_flax,
    )

    ref_sd = reference_3d.state_dict()
    back = ti.port_state_dict_to_reference(ti.reference_state_dict_to_port(ref_sd))
    wanted = {k for k in ref_sd if "num_batches_tracked" not in k and "_slice." not in k}
    assert set(back) == wanted
    jax_back = flax_variables_to_torch_state_dict(torch_state_dict_to_flax(ref_sd))
    assert set(jax_back) == wanted
    for k, v in back.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref_sd[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), jax_back[k], err_msg=k)


def test_reference_2d_state_dict_gives_its_logits_and_jax(reference_2d):
    """The port's 2D model with a torchvision-layout state dict: eval logits
    within 2e-4 (the tolerance of `tests/test_torch_parity_2d.py`) of the
    reference model's and of JAX's; the layout round-trips exactly."""
    from deep_staple_tpu.models.lraspp2d import LRASPPMobileNetV3Large2D as JaxLRASPP2D
    from deep_staple_tpu.models.torch_interop import torchvision_lraspp2d_to_flax
    from deep_staple_torch.models.lraspp2d import LRASPPMobileNetV3Large2D

    x = np.random.RandomState(7).randn(2, 1, *HW).astype(np.float32)
    with torch.no_grad():
        want = reference_2d(torch.from_numpy(x)).numpy()
    model = ti.load_reference_state_dict(LRASPPMobileNetV3Large2D(num_classes=2),
                                         reference_2d.state_dict())
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(np.moveaxis(x, 1, -1)))["out"].numpy()
    got = np.moveaxis(got, -1, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jax_out = JaxLRASPP2D(num_classes=2).apply(
        torchvision_lraspp2d_to_flax(reference_2d.state_dict()),
        jnp.asarray(np.moveaxis(x, 1, -1)), train=False)["out"]
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(jax_out), -1, 1), rtol=2e-4, atol=2e-4)

    ref_sd = reference_2d.state_dict()
    back = ti.port_lraspp2d_to_torchvision(model.state_dict())
    assert set(back) == {k for k in ref_sd if "num_batches_tracked" not in k}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k].numpy(), err_msg=k)


def test_load_reference_state_dict_is_strict(reference_3d):
    """A missing tensor or a key of another layout raises."""
    from deep_staple_torch.models import MobileNetLRASPP3D

    sd = dict(reference_3d.state_dict())
    sd.pop("head.cbr.1.running_var")
    with pytest.raises(KeyError):
        ti.load_reference_state_dict(MobileNetLRASPP3D(num_classes=2), sd)
    with pytest.raises(KeyError):  # a 3D state dict does not fit the 2D model
        from deep_staple_torch.models.lraspp2d import LRASPPMobileNetV3Large2D

        ti.load_reference_state_dict(LRASPPMobileNetV3Large2D(num_classes=2),
                                     reference_3d.state_dict())
