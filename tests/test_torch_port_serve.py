"""The port's serving path as a whole against the JAX package's, on the CPU.

One set of weights is saved twice: as a JAX checkpoint (`create_state` with
perturbed BatchNorm statistics, JAX `save_checkpoint`) and, carried through
`models/interop.py`, as a port checkpoint. Both `serve.main`s then segment
the same NIfTI volumes at eval x2.0 with batch 2, so the last batch is
padded.
"""

import numpy as np
import pytest
import torch

import jax

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.data.nifti import load_nifti
from deep_staple_tpu.serve import main as jax_serve_main
from deep_staple_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from deep_staple_tpu.train.driver import make_model as jax_make_model
from deep_staple_tpu.train.state import create_state
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.nifti import save_nifti
from deep_staple_torch.models.interop import load_flax_variables
from deep_staple_torch.ops.resample import interpolate_sample
from deep_staple_torch.serve import main as serve_main
from deep_staple_torch.serve import preprocess
from deep_staple_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from deep_staple_torch.train.driver import make_model

torch.set_num_threads(1)

SIZE = (16, 16, 16)
SHAPES = [(15, 14, 13), (17, 12, 16), (13, 15, 14)]
AFFINES = [np.diag([1.0, 2.0, 3.0, 1.0]), np.diag([0.8, 0.8, 1.5, 1.0]), np.eye(4)]


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.3, 2.0, v.shape).astype(np.float32)
        elif k == "bias":
            out[k] = (np.asarray(v) + rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.array(v)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    jcfg = JaxConfig(crop_3d_w_dim_range=None, use_checkpointing=False)
    jm, in_ch = jax_make_model(jcfg, num_classes=2)
    state, _ = create_state(jm, (1, *SIZE, in_ch), dataset_len=5)
    rng = np.random.RandomState(0)
    variables = {
        "params": _perturb(jax.tree.map(np.asarray, state.params), rng),
        "batch_stats": _perturb(jax.tree.map(np.asarray, state.batch_stats), rng),
    }
    vols = []
    for shape in SHAPES:
        vol = rng.randn(*shape).astype(np.float32)
        vols.append(vol + np.linspace(-2, 2, shape[0], dtype=np.float32)[:, None, None])

    cfg = TrainConfig.from_dict(jcfg.to_dict())
    model, _ = make_model(cfg, num_classes=2)
    load_flax_variables(model, variables)
    # Shift the class-1 bias to the median logit margin of the first volume,
    # so that the label maps hold both classes and the comparison has teeth.
    img = torch.from_numpy(preprocess(vols[0], cfg, SIZE))[None]
    with torch.inference_mode():
        logits = model.eval()(interpolate_sample(img, None, 2.0)[0][..., None])["out"]
    margin = float((logits[..., 1] - logits[..., 0]).median())
    variables["params"]["head"]["Conv_1"]["bias"][1] -= margin
    load_flax_variables(model, variables)
    save_checkpoint(tmp / "ckpt_port", model, np.asarray(state.dp_params), cfg)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    jax_save_checkpoint(tmp / "ckpt_jax", state, jcfg)

    inputs = []
    for i, (vol, aff) in enumerate(zip(vols, AFFINES)):
        p = tmp / f"case{i}.nii.gz"
        save_nifti(p, vol, affine=aff)
        inputs.append(str(p))

    common = ["--inputs", *inputs, "--batch-size", "2", "--size", *map(str, SIZE),
              "--eval-scale", "2.0"]
    jax_serve_main(["--checkpoint", str(tmp / "ckpt_jax"), "--output-dir", str(tmp / "out_jax"),
                    *common])
    result = serve_main(["--checkpoint", str(tmp / "ckpt_port"),
                         "--output-dir", str(tmp / "out_port"), "--device", "cpu", *common])
    return tmp, result


def test_serve_executions_and_paths(served):
    tmp, result = served
    assert result.executions == 2  # 3 volumes at batch 2: the last batch is padded
    assert [p.name for p in result.paths] == [f"case{i}_seg.nii.gz" for i in range(3)]
    assert len(result.batch_ms) == 2


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_serve_label_maps_match_jax(served, i):
    tmp, _ = served
    want = load_nifti(tmp / "out_jax" / f"case{i}_seg.nii.gz")
    got = load_nifti(tmp / "out_port" / f"case{i}_seg.nii.gz")
    assert got.shape == want.shape == SHAPES[i]
    assert got.data.dtype == want.data.dtype == np.int16
    np.testing.assert_array_equal(got.affine, want.affine)
    assert set(np.unique(got.data)) <= {0, 1}
    assert 0.02 < want.data.mean() < 0.98  # both classes present
    # Logits agree to ~1e-6; only near-ties of the two classes may flip.
    assert (got.data == want.data).mean() >= 0.999


def test_port_checkpoint_restores_dp_length(served):
    tmp, _ = served
    model, _ = make_model(TrainConfig(crop_3d_w_dim_range=None), 2)
    dp = restore_checkpoint(tmp / "ckpt_port", model)
    assert dp.shape == (5,) and dp.dtype == torch.float32


def test_eval_space_writer_matches_jax(tmp_path):
    from deep_staple_tpu.serve import _make_output_writer as jax_writer
    from deep_staple_torch.serve import _make_output_writer as port_writer

    pred = (np.random.RandomState(1).rand(24, 24, 14) > 0.5).astype(np.int32)
    meta = (tmp_path / "vol.nii.gz", (15, 14, 13), np.diag([1.0, 2.0, 3.0, 1.0]))
    for crop in ((2, 9), None):
        for space in ("eval", "input"):
            outs = []
            for name, writer, cfg_cls in (("j", jax_writer, JaxConfig), ("t", port_writer, TrainConfig)):
                d = tmp_path / f"{name}_{space}_{crop is None}"
                d.mkdir()
                size = (12, 12, 12) if crop else (12, 12, 7)  # eval grid is 2x (12, 12, 7)
                write = writer(d, cfg_cls(crop_3d_w_dim_range=crop), size, 2.0, space)
                outs.append(load_nifti(write(pred, meta)))
            np.testing.assert_array_equal(outs[0].data, outs[1].data)
            np.testing.assert_array_equal(outs[0].affine, outs[1].affine)
