"""The JAX package's checkpoints served and resumed by the port, on the CPU.

The JAX package writes `state.msgpack` + `config.json` with its own
`save_checkpoint` after a train step; the port reads it with its own msgpack
decoder (`train/flax_msgpack.py`) and `models/interop.state_from_jax`:

  * `serve.load_serving_state` gives eval logits within the tolerances of
    `test_torch_port_model.py` against JAX's eval of the same state;
  * `restore_checkpoint` takes the next train step, held to JAX's next step
    from the same checkpoint within the tolerances of
    `test_torch_port_step.py`'s fused / async case: the losses, the DP rows,
    the weights' update, the running statistics, and both optimizers'
    moments;
  * the serve CLI, in a subprocess with `--device cpu`, segments volumes
    from the JAX checkpoint as JAX's serve does.

Augmentation is off and dropout 0 in the step comparison, as in
`test_torch_port_step.py`. Set-up is in `torch_port_state.py`. The JAX
driver's fold checkpoints are resumed in `test_torch_port_jax_resume.py`.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.data.nifti import load_nifti
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.serve import main as jax_serve_main
from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from deep_staple_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.nifti import save_nifti
from deep_staple_torch.models.interop import state_dict_to_flax, state_to_jax
from deep_staple_torch.serve import load_serving_state
from deep_staple_torch.train.checkpoint import restore_checkpoint
from deep_staple_torch.train.state import create_state
from deep_staple_torch.train.step import make_train_step
from torch_port_state import CW, N, SPATIAL, diff, flat, jax_state, norm, port_model, t
from torch_port_state import batch as make_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = dict(ool_mode="fused", bn_mode="async", use_checkpointing=False, crop_3d_w_dim_range=None)
SEED = 6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX checkpoint after one JAX step from a warm state; JAX's next
    step from it (restored by JAX); the port's next step from it."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg = TrainConfig(**CONFIG)
    model, variables = port_model(cfg, SEED)
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0, bn_mode="async")
    rng = np.random.RandomState(SEED)
    dp0 = (rng.randn(N) * 0.1).astype(np.float32)
    fixed = (4.0 + rng.rand(N)).astype(np.float32)
    tx = joptim.make_model_optimizer(0.01)
    jstep = jax_make_train_step(jm, tx, JaxConfig(**CONFIG), CW, fixed, augment=False)
    jstate1, _ = jstep(jax_state(variables, dp0, tx, warm=True), make_batch(SEED), 0.01,
                       jax.random.PRNGKey(0))
    jax_save_checkpoint(root / "ckpt", jstate1, JaxConfig(**CONFIG))

    batch2 = make_batch(SEED + 1)
    restored = jax_restore_checkpoint(root / "ckpt", jstate1)
    jstate2, jmet2 = jstep(restored, batch2, 0.005, jax.random.PRNGKey(1))

    pstate1 = restore_checkpoint(root / "ckpt", create_state(model, N, seed=99, device="cpu"))
    start = state_to_jax(pstate1)
    step = make_train_step(model, cfg, CW, fixed, augment=False)
    pstate2, pmet2 = step(pstate1, {k: t(v) for k, v in batch2.items()}, 0.005)
    return root, jm, jstate1, (jstate2, jmet2), (pstate2, pmet2), start


def test_restored_state_equals_the_jax_state(ckpt):
    """Restoring carries every leaf bit for bit: the port's state written
    back in JAX's layout equals what flax decodes from the file."""
    root, _, _, _, _, start = ckpt
    want = serialization.msgpack_restore((root / "ckpt" / "state.msgpack").read_bytes())
    for key in ("params", "batch_stats"):
        got_leaves, want_leaves = dict(flat(start[key])), dict(flat(want[key]))
        assert sorted(got_leaves) == sorted(want_leaves)
        for path, v in want_leaves.items():
            assert got_leaves[path].dtype == v.dtype and np.array_equal(got_leaves[path], v), path
    adam, jadam = start["opt_state"]["inner_state"]["0"], want["opt_state"]["inner_state"]["0"]
    for m in ("mu", "nu"):
        for path, v in flat(jadam[m]):
            np.testing.assert_array_equal(dict(flat(adam[m]))[path], v)
    assert int(adam["count"]) == int(jadam["count"]) == 11
    for k in ("mu", "nu", "count"):
        np.testing.assert_array_equal(start["dp_opt_state"][k], want["dp_opt_state"][k])
    np.testing.assert_array_equal(start["dp_params"], want["dp_params"])
    assert int(start["step"]) == int(want["step"]) == 1


def test_next_step_from_jax_checkpoint_matches_jax(ckpt):
    """The port's step from the JAX checkpoint against JAX's, with
    `test_torch_port_step.py`'s fused / async tolerances (losses 2e-5, DP
    rows 1e-4 / 2e-6, weights' update 5e-4 of its norm, statistics 1e-4),
    and the moments: AdamW's change over the step within 5e-4 of its norm,
    SparseAdam's rows as the DP rows."""
    _, _, jstate1, (jstate2, jmet), (pstate2, pmet), start = ckpt
    np.testing.assert_allclose(float(pmet["ce_loss"]), float(jmet["ce_loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(pmet["dp_loss"]), float(jmet["dp_loss"]), rtol=2e-5)
    np.testing.assert_allclose(pstate2.dp_params.numpy(), np.asarray(jstate2.dp_params),
                               rtol=1e-4, atol=2e-6)
    batch2 = make_batch(SEED + 1)
    untouched = np.setdiff1d(np.arange(N), batch2["dataset_idx"])
    np.testing.assert_array_equal(pstate2.dp_params.numpy()[untouched],
                                  np.asarray(jstate1.dp_params)[untouched])
    for k in ("mu", "nu"):
        np.testing.assert_allclose(getattr(pstate2.dp_opt_state, k).numpy(),
                                   np.asarray(getattr(jstate2.dp_opt_state, k)),
                                   rtol=1e-4, atol=2e-6)
    assert int(pstate2.dp_opt_state.count) == int(jstate2.dp_opt_state.count) == 2
    assert pstate2.step == int(jstate2.step) == 2

    got = state_dict_to_flax(pstate2.model.state_dict())
    jparams = jax.tree.map(np.asarray, jstate2.params)
    upd_port = norm({"u": diff(got["params"], start["params"])})
    upd_jax = norm({"u": diff(jparams, start["params"])})
    np.testing.assert_allclose(upd_port, upd_jax, rtol=5e-4)
    want_stats = dict(flat(jax.tree.map(np.asarray, jstate2.batch_stats)))
    for path, v in flat(got["batch_stats"]):
        w = want_stats[path]
        if path[-1] == "count":
            assert int(v) == int(w), path
        else:
            np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg="/".join(path))

    now = state_to_jax(pstate2)["opt_state"]["inner_state"]["0"]
    jadam = jax.tree.map(np.asarray, jstate2.opt_state.inner_state[0])
    assert int(now["count"]) == int(jadam.count) == 12
    for m in ("mu", "nu"):
        before = start["opt_state"]["inner_state"]["0"][m]
        change_jax = norm({"c": diff(getattr(jadam, m), before)})
        gap = norm({"g": diff(now[m], getattr(jadam, m))})
        assert gap <= 5e-4 * change_jax, (m, gap, change_jax)


def test_serving_state_from_jax_checkpoint_matches_jax_eval(ckpt):
    """`load_serving_state` on the JAX directory: the DP vector of the file,
    and eval logits within `test_torch_port_model.py`'s rtol 1e-4 / atol
    2e-5 of JAX's eval of the same state."""
    root, jm, jstate1, _, _, _ = ckpt
    model, config, dp, num_classes = load_serving_state(root / "ckpt", device="cpu")
    assert config.bn_mode == "async" and num_classes == 2
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jstate1.dp_params))
    x = np.random.RandomState(3).randn(1, *SPATIAL, 1).astype(np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False)["out"])(
        {"params": jstate1.params, "batch_stats": jstate1.batch_stats}, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))["out"].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=2e-5)


def test_serve_cli_on_jax_checkpoint(ckpt, tmp_path):
    """`python -m deep_staple_torch.serve --device cpu` on the JAX directory
    writes label maps on each input's grid that agree with JAX's serve of
    the same directory (>= 99.9% of the voxels, as
    `test_torch_port_serve.py`: only near-ties of the two classes flip)."""
    root = ckpt[0]
    rng = np.random.RandomState(4)
    inputs = []
    for i, shape in enumerate([(15, 14, 13), (17, 12, 16)]):
        vol = rng.randn(*shape).astype(np.float32)
        vol += np.linspace(-2, 2, shape[0], dtype=np.float32)[:, None, None]
        inputs.append(str(tmp_path / f"case{i}.nii.gz"))
        save_nifti(inputs[-1], vol, affine=np.diag([1.0, 1.5, 2.0, 1.0]))
    common = ["--checkpoint", str(root / "ckpt"), "--inputs", *inputs, "--batch-size", "2",
              "--size", "16", "16", "16"]
    proc = subprocess.run(
        [sys.executable, "-m", "deep_staple_torch.serve", "--device", "cpu",
         "--output-dir", str(tmp_path / "port"), *common],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served 2 volumes" in proc.stdout and "on cpu" in proc.stdout
    jax_serve_main(["--output-dir", str(tmp_path / "jax"), *common])
    for i in range(2):
        got = load_nifti(tmp_path / "port" / f"case{i}_seg.nii.gz")
        want = load_nifti(tmp_path / "jax" / f"case{i}_seg.nii.gz")
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.affine, want.affine)
        assert (got.data == want.data).mean() >= 0.999
