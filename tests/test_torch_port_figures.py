"""The port's figures (`consensus/figures.py`, `utils/visualization.py`)
against the JAX package's, on the CPU, and where the port draws them.

The consensus figures are the port's versions of `tests/test_consensus_
figures.py`, the overlays those of `tests/test_utils_tools.py`'s
visualization cases. Both packages draw from the same dicts and arrays (the
consensus dicts of the port's `evaluate_consensus` over
`test_consensus_batched._snapshot`): `consensus_dice_arrays` is held
bitwise, each PNG decoded to its pixels and held equal, each RGB grid equal.
matplotlib is the same on both sides here. Then: `train_dl` with
`save_dp_figures` and `do_plot` writes its figures at the JAX driver's paths
(`deep_staple_tpu/train/driver.py:536-545`, `:650-660`), the pipeline's
`--plot-dir` writes each fold's figure set, and without matplotlib every
entry point raises ImportError naming it, before any work.
"""

import pickle
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from deep_staple_tpu.consensus import figures as jfig
from deep_staple_tpu.utils import visualization as jvis
from deep_staple_torch.consensus import figures as pfig
from deep_staple_torch.consensus.evaluate import evaluate_consensus, extract_consensus_dices
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.prepare import prepare_data
from deep_staple_torch.utils import visualization as pvis
from test_consensus_batched import _snapshot

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cd():
    return evaluate_consensus(_snapshot(np.random.RandomState(0)), staple_max_iterations=40,
                              device="cpu")


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)


def test_boxplot_two_runs_with_baselines(cd, tmp_path):
    dp, st = pfig.consensus_dice_arrays(cd)
    jdp, jst = jfig.consensus_dice_arrays(cd)
    assert dp.tobytes() == jdp.tobytes() and st.tobytes() == jst.tobytes()
    assert st.shape == dp.shape == (3,) and np.all((0 <= st) & (st <= 1))
    dp2, st2 = extract_consensus_dices(cd)
    assert np.allclose(dp, dp2) and np.allclose(st, st2)
    kw = dict(baselines={"deeds": [28.9, 48.0, 56.9], "convex_adam": [20.8, 49.5, 60.0]},
              oracle={"deeds": 84.4, "convex_adam": 83.8}, title="consensus comparison")
    runs = {"deeds": cd, "convex_adam": (dp * 0.95, st * 0.9)}
    out = pfig.save_consensus_boxplot(runs, tmp_path / "port.png", **kw)
    jfig.save_consensus_boxplot(runs, tmp_path / "jax.png", **kw)
    assert out == tmp_path / "port.png" and out.stat().st_size > 2000
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")


def test_boxplot_single_run_no_baselines(cd, tmp_path):
    out = pfig.save_consensus_boxplot({"run": cd}, tmp_path / "port.png")
    jfig.save_consensus_boxplot({"run": cd}, tmp_path / "jax.png")
    assert out.stat().st_size > 2000
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")


def test_atlas_weighting_figure(cd, tmp_path):
    f_id = next(iter(cd))
    pfig.save_atlas_weighting_figure(cd, f_id, tmp_path / "port.png")
    jfig.save_atlas_weighting_figure(cd, f_id, tmp_path / "jax.png")
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")
    p = tmp_path / "cd.pkl"  # a pickled path as input, with an explicit slice
    p.write_bytes(pickle.dumps(cd))
    pfig.save_atlas_weighting_figure(p, f_id, tmp_path / "port2.png", z_slice=3)
    jfig.save_atlas_weighting_figure(p, f_id, tmp_path / "jax2.png", z_slice=3)
    _same_png(tmp_path / "port2.png", tmp_path / "jax2.png")
    paths = pfig.save_all_figures(cd, tmp_path / "all")
    assert [q.name for q in paths] == ["consensus_boxplot.png"] + [
        f"weighting_{f}.png" for f in cd]


def _both(tmp_path, **kw):
    """visualize_seg of each package on the same arguments, and its PNG."""
    out = []
    for name, mod in (("port", pvis), ("jax", jvis)):
        fp = tmp_path / f"{name}.png" if tmp_path is not None else None
        out.append(mod.visualize_seg(**kw, file_path=fp))
    np.testing.assert_array_equal(out[0], out[1])
    if tmp_path is not None:
        _same_png(tmp_path / "port.png", tmp_path / "jax.png")
    return out[0]


def test_visualize_seg_grid(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.rand(3, 10, 12, 8).astype(np.float32)
    seg = (rng.rand(3, 10, 12, 8) > 0.7).astype(np.int32)
    out = _both(None, in_type="batch_3D", reduce_dim="W", img=img, seg=seg, ground_truth=seg,
                overlay_text=["a", "b", "c"], frame_elements=[True, False, False])
    assert out.ndim == 3 and out.shape[-1] == 3
    pvis.visualize_seg(in_type="batch_3D", reduce_dim="W", img=img, seg=seg,
                       file_path=tmp_path / "sub" / "viz.png")
    assert (tmp_path / "sub" / "viz.png").is_file()


def test_get_cmap_dict_matches_reference_formula():
    assert pvis.get_cmap_dict(1) == jvis.get_cmap_dict(1) == {0: None, 1: (255, 0, 40)}
    assert pvis.get_cmap_dict(3) == jvis.get_cmap_dict(3) == {
        0: None, 1: (255, 0, 40), 2: (91, 255, 0), 3: (0, 143, 255)}
    assert pvis.get_cmap_dict(4, "viridis", False) == jvis.get_cmap_dict(4, "viridis", False)


def test_visualize_offcenter_label_slice_and_cmap():
    img = np.zeros((6, 5, 4), np.float32)
    seg = np.zeros((6, 5, 4), np.int32)
    seg[2:4, 1:3, 3] = 1  # off-centre: only at W=3
    out = _both(None, in_type="single_3D", reduce_dim="W", img=img, seg=seg, alpha_seg=1.0)
    expected = np.zeros((6, 5, 3), np.uint8)
    expected[2:4, 1:3] = (255, 0, 40)
    np.testing.assert_array_equal(out, expected)
    out2 = _both(None, in_type="single_3D", reduce_dim="W", img=img, seg=seg, alpha_seg=1.0,
                 onehot_color_map={0: None, 1: (0, 255, 0)}, crop_to_non_zero_seg=True)
    assert tuple(out2[2, 1]) == (0, 255, 0)


def test_visualize_frame_uses_annotate_color(tmp_path):
    img = np.random.RandomState(1).rand(2, 8, 9).astype(np.float32)
    out = _both(tmp_path, in_type="batch_2D", img=img, frame_elements=[True, False],
                annotate_color=(10, 20, 30), overlay_text=["x", "y"])
    assert tuple(out[0, 0]) == (10, 20, 30)
    assert tuple(out[0, 9]) != (10, 20, 30)


def test_visualize_single_2d():
    img = np.random.RandomState(2).rand(12, 9)
    out = _both(None, in_type="single_2D", img=img, seg=(img > 0.8).astype(np.int32))
    assert out.shape == (12, 9, 3)


def test_parameter_figure_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    params = rng.randn(40).astype(np.float32)
    args = ("run", "corr. coeff. 0.5", params, params / 4.5, rng.rand(40))
    pvis.save_parameter_figure(tmp_path / "p" / "port.png", *args)
    jvis.save_parameter_figure(tmp_path / "j" / "jax.png", *args)
    _same_png(tmp_path / "p" / "port.png", tmp_path / "j" / "jax.png")


def _train_config(root, **kw):
    return TrainConfig(
        dataset="synthetic", reg_state="synthetic", dataset_directory=str(root / "ds"),
        crop_3d_w_dim_range=None, batch_size=4, num_val_images=1, use_checkpointing=False,
        ool_mode="fused", save_every=1000, output_dir=str(root / "out"),
        mdl_save_prefix=str(root / "models"), log_jsonl=False, **kw)


def test_train_dl_draws_figures_where_jax_does(tmp_path):
    """save_dp_figures: the DP scatter of batches 0, 10, ... of each epoch at
    `<output_dir>/<run>_fold<k>_figures/dp_figure_epx<e>_batch<b>.png`;
    do_plot: the DP-sorted overview beside the snapshot."""
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    cfg = _train_config(tmp_path, epochs=2, save_dp_figures=True, do_plot=True)
    res = pd.train_dl("figs", cfg, *prepare_data(cfg), device="cpu")[0]
    figs = sorted(p.name for p in (tmp_path / "out" / "figs_fold0_figures").iterdir())
    assert figs == ["dp_figure_epx000_batch000.png", "dp_figure_epx001_batch000.png"]
    overview = res["snapshot_path"].parent / "data_parameter_weighted_samples.png"
    assert res["snapshot_path"].parent.name == "figs_fold0_epx1"
    assert _pixels(overview).shape[1] == 4 * 20  # 4 training tiles of 20 x 20 (x2.0)


def test_pipeline_plot_dir_writes_each_fold(tmp_path):
    from deep_staple_torch.pipeline import run_pipeline

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    cfg = _train_config(tmp_path, epochs=1, device="cpu")
    summary = run_pipeline(cfg, run_name="p", staple_iterations=20, plot_dir=tmp_path / "plots")
    assert summary[0]["plots"] == str(tmp_path / "plots" / "fold0")
    names = sorted(p.name for p in (tmp_path / "plots" / "fold0").iterdir())
    assert names[0] == "consensus_boxplot.png" and len(names) == 3  # two fixed images


@pytest.mark.parametrize("kw", [dict(save_dp_figures=True), dict(do_plot=True)])
def test_figure_options_pass_check_supported(kw):
    """The figures are ported: the options that raised before pass."""
    pd.check_supported(TrainConfig(**kw))


@pytest.mark.parametrize("entry", ["train_dl", "consensus_cli", "pipeline", "boxplot",
                                   "parameter_figure"])
def test_without_matplotlib_figures_raise_import_error(tmp_path, monkeypatch, cd, entry):
    """Where matplotlib is missing, every figure entry point raises
    ImportError naming it, before any training or consensus work; nothing
    is skipped."""
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    monkeypatch.setattr(pd, "precompute_sample_metrics", lambda *a, **k: pytest.fail("ran"))
    calls = {
        "train_dl": lambda: pd.train_dl("x", TrainConfig(save_dp_figures=True), None,
                                        device="cpu"),
        "consensus_cli": lambda: __import__("deep_staple_torch.consensus.__main__", fromlist=["main"])
        .main(["--snapshot", "missing.npz", "--output", str(tmp_path / "o.pkl"),
               "--device", "cpu", "--plot-dir", str(tmp_path / "f")]),
        "pipeline": lambda: __import__("deep_staple_torch.pipeline", fromlist=["run_pipeline"])
        .run_pipeline(TrainConfig(device="cpu"), plot_dir=tmp_path / "f"),
        "boxplot": lambda: pfig.save_consensus_boxplot({"run": cd}, tmp_path / "b.png"),
        "parameter_figure": lambda: pvis.save_parameter_figure(
            tmp_path / "p.png", "t", "x", np.zeros(3), np.zeros(3), np.zeros(3)),
    }
    with pytest.raises(ImportError, match="matplotlib"):
        calls[entry]()
    assert not list(tmp_path.iterdir())
