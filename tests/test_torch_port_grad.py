"""The port's depthwise-conv backward (input and weight gradients, strides 1
and 2) against JAX's VJPs, on the CPU.

On a CPU tensor the wrappers take their plain versions; the CUDA kernels are
held against those plain versions on the card by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.ops.conv3d import depthwise_conv3d_shifted
from deep_staple_tpu.ops.conv3d_pallas import depthwise_conv3d_pallas
from deep_staple_torch.ops.conv3d_dw import (
    depthwise_conv3d,
    depthwise_conv3d_grad_w,
    depthwise_conv3d_grad_w_plain,
    depthwise_conv3d_grad_x,
    depthwise_conv3d_grad_x_plain,
    depthwise_conv3d_plain,
    out_extent,
)

torch.set_num_threads(1)

# Odd extents, C not a multiple of the vector width, and one model-like C;
# then stride-2 extents of 1 and 2, where an odd input has no cotangent o + 1.
CASES = [
    ((2, 7, 5, 4), 5, 1),
    ((2, 7, 5, 4), 5, 2),
    ((1, 9, 7, 5), 6, 2),
    ((1, 8, 6, 5), 130, 1),
    ((1, 8, 6, 5), 130, 2),
    ((2, 6, 6, 5), 32, 1),
    ((1, 2, 1, 3), 8, 2),
    ((1, 10, 12, 9), 48, 2),
]


def _inputs(shape, C, stride, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    w = rng.randn(3, 3, 3, 1, C).astype(np.float32)
    g = rng.randn(shape[0], *(out_extent(n, stride) for n in shape[1:]), C).astype(np.float32)
    return x, w, g


def _jax_vjp(fn, x, w, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    return np.asarray(gx), np.asarray(gw).reshape(27, -1)


@pytest.mark.parametrize("shape,C,stride", CASES)
def test_depthwise_backward_matches_jax(shape, C, stride):
    x, w, g = _inputs(shape, C, stride, seed=C + stride)
    want_gx, want_gw = _jax_vjp(lambda a, b: depthwise_conv3d_shifted(a, b, stride), x, w, g)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.reshape(27, C)).requires_grad_(True)
    y = depthwise_conv3d(xt, wt, stride)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    assert gx.dtype == torch.float32 and gw.dtype == torch.float32 and tuple(gw.shape) == (27, C)
    np.testing.assert_allclose(gx.numpy(), want_gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), want_gw, rtol=0, atol=1e-5 * np.abs(want_gw).max())

    if stride == 1:  # the Pallas kernel's own VJP, in interpret mode
        p_gx, p_gw = _jax_vjp(depthwise_conv3d_pallas, x, w, g)
        np.testing.assert_allclose(gx.numpy(), p_gx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gw.numpy(), p_gw, rtol=0, atol=1e-5 * np.abs(p_gw).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_backward_plain_functions_gradcheck(stride):
    """float64 gradcheck of the forward through the two plain backward
    functions (the autograd.Function on CPU tensors)."""
    rng = np.random.RandomState(stride)
    x = torch.from_numpy(rng.randn(1, 5, 4, 3, 2)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(27, 2)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: depthwise_conv3d(a, b, stride), (x, w))


def test_backward_is_the_plain_functions():
    """The wrappers on CPU tensors are the plain functions, and the plain
    input gradient is the adjoint of the plain forward."""
    x, w, g = _inputs((1, 7, 6, 5), 4, 2, seed=11)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w.reshape(27, 4), g))
    assert torch.equal(depthwise_conv3d_grad_x(gt, wt, 2, xt.shape),
                       depthwise_conv3d_grad_x_plain(gt, wt, 2, xt.shape))
    assert torch.equal(depthwise_conv3d_grad_w(xt, gt, 2), depthwise_conv3d_grad_w_plain(xt, gt, 2))
    # <A x, g> == <x, A^T g>
    lhs = (depthwise_conv3d_plain(xt.double(), wt.double(), 2) * gt.double()).sum()
    rhs = (xt.double() * depthwise_conv3d_grad_x_plain(gt.double(), wt.double(), 2, xt.shape)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_bf16_backward_dtypes_and_weight_cast():
    """A bf16 input gives a bf16 input gradient; weights cast to bf16 before
    the call, as the bf16 model does, get a float32 gradient rounded through
    that cast, as in JAX."""
    x, w, g = _inputs((1, 6, 5, 4), 8, 1, seed=12)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w.reshape(27, 8)).requires_grad_(True)
    y = depthwise_conv3d(xt, wt.to(torch.bfloat16).float(), 1)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).to(torch.bfloat16))
    assert y.dtype == gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert torch.equal(gw, gw.to(torch.bfloat16).float())

    jx = jnp.asarray(xt.detach().float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: depthwise_conv3d_shifted(a, b.astype(jnp.bfloat16), 1),
                     jx, jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(jgx, np.float32), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw).reshape(27, 8), rtol=1e-2,
                               atol=1e-2 * np.abs(np.asarray(jgw)).max())
