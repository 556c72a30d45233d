"""`train_dl` of the port against the JAX driver on the CPU, and its helpers.

Both drivers train on the same synthetic fixture in float32 with async
BatchNorm after one slab warm-up epoch, for 3 epochs of 2 steps, from the
same weights: the JAX driver's initial state (built here from seeded
weights, which saves the JAX init's compile) goes to the port through
`models/interop.state_from_jax`. Augmentation and dropout are off on both
sides (the two packages' random numbers differ); the tests monkeypatch
`make_train_step` (augment=False) and `make_model` (dropout 0) in both
drivers, `create_state` in both, and the JAX driver's snapshot export (the
two exports are compared at equal weights in `test_torch_port_snapshot.py`).

Tolerances. The measured gaps: per-epoch mean losses 3.3e-4, 1.1e-3 and
4.3e-3 relative, the final DP vector 9.1e-3 at most, a Dice 7.8e-3. Their
source is JAX's side: on the CPU its class-weighted CE sums the batch's
27,648 float32 terms in sequence and is off by 2.7e-4 of the float64 value
at the first step already (the port's is within 2e-7; the logits agree to
3e-5 and the DP loss to 3e-6), which scales the CE gradient by as much, and
the switch from slab to async BatchNorm after the warm-up epoch amplifies
such gaps over the six steps. The tolerances are about twice the gaps:
losses 1e-2 relative, DP values and Dice 2e-2 absolute. Over the three
chained epochs the per-epoch losses of both packages drift from a float64
run by up to 1.2e-2, in opposite directions, so the loss test runs each
later epoch in both drivers from one shared state, JAX's checkpoint of the
epoch before it (gaps 2.8e-4, 8.7e-5 and 5.0e-5).
"""

import shutil

import numpy as np
import pytest
import torch

import jax

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.train import driver as jd
from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.prepare import prepare_data as jax_prepare
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.snapshot_io import load_snapshot
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.models import init_weights
from deep_staple_torch.models.interop import state_dict_to_flax, state_from_jax
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.prepare import prepare_data
from torch_port_state import jax_state

torch.set_num_threads(1)

SNAPSHOT_KEYS = ["d_ids", "data_parameters", "dataset_idxs", "disturb_flags", "image_paths",
                 "label_paths", "labels", "modified_labels", "train_predictions"]


def _config(cls, root, tag):
    return cls.tpu_production(
        dataset="synthetic", reg_state="synthetic", dataset_directory=str(root),
        crop_3d_w_dim_range=None, compute_dtype="float32", bn_warmup_epochs=1,
        epochs=3, batch_size=3, num_val_images=1, save_every=1, log_jsonl=False, lr=1e-3,
        output_dir=str(root / f"out_{tag}"), mdl_save_prefix=str(root / f"models_{tag}"),
    )


def _jax_initial_state(n):
    """A JAX train state at seeded weights, as JAX's create_state returns it,
    with AdamW warm (as after 10 steps, second moments 1e-4): a cold AdamW's
    first update is lr * g / |g|, whose sign flips in near-zero gradients
    would swamp the comparison (`torch_port_state.jax_state`)."""
    cfg = TrainConfig.tpu_production(compute_dtype="float32")
    model, _ = pd.make_model(cfg, 2)
    init_weights(model, torch.Generator().manual_seed(7))
    variables = state_dict_to_flax(model.state_dict())
    tx = joptim.make_model_optimizer(0.01)
    return jax_state(variables, np.zeros(n, np.float32), tx, warm=True), tx


def _cast_state(state, dtype):
    """The port's train state with its model, AdamW's moments, the DP
    vector and SparseAdam's moments in `dtype` (in place)."""
    state.model.to(dtype)
    for moments in state.optimizer.state.values():
        for k, v in moments.items():
            if k != "step" and torch.is_floating_point(v):
                moments[k] = v.to(dtype)
    o = state.dp_opt_state
    state.dp_params = state.dp_params.to(dtype)
    state.dp_opt_state = type(o)(mu=o.mu.to(dtype), nu=o.nu.to(dtype), count=o.count)
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    generate_synthetic_crossmoda(root, num_cases=4, atlas_count=2, size=(24, 24, 16), seed=1)
    mp = pytest.MonkeyPatch()
    init = {}

    def jax_create_state(model, input_shape, dataset_len, **kw):
        init["state"], tx = _jax_initial_state(dataset_len)
        return init["state"], tx

    port_dtype = {"dtype": torch.float32}

    def port_create_state(model, dataset_len, **kw):
        state = state_from_jax(jax.tree.map(np.asarray, init["state"]), model, device="cpu")
        return _cast_state(state, port_dtype["dtype"])

    orig_port_make_model, orig_jax_make_model = pd.make_model, jd.make_model
    orig_port_step, orig_jax_step = pd.make_train_step, jd.make_train_step
    orig_port_eval = pd.make_eval_step

    def port_eval(*a, **k):
        step = orig_port_eval(*a, **k)
        return lambda batch: step(dict(batch, image=batch["image"].to(port_dtype["dtype"])))

    def port_make_model(config, num_classes):
        model, in_ch = orig_port_make_model(config, num_classes)
        model.aspp.dropout_rate = 0.0
        return model, in_ch

    steps = {"jax": [], "port": [], "f64": []}

    def recording(make_train_step, tag):
        def make(*a, **k):
            step = make_train_step(*a, augment=False, **k)

            def run(state, batch, *aa, **kk):
                if isinstance(batch["image"], torch.Tensor):
                    batch = dict(batch, image=batch["image"].to(port_dtype["dtype"]))
                state, metrics = step(state, batch, *aa, **kk)
                if tag is not None:
                    steps[tag].append((float(metrics["loss"]), float(metrics["ce_loss"])))
                return state, metrics
            return run
        return make

    mp.setattr(jd, "make_train_step", recording(jd.make_train_step, "jax"))
    mp.setattr(jd, "make_model", lambda c, n: (orig_jax_make_model(c, n)[0].clone(dropout_rate=0.0), 1))
    mp.setattr(jd, "create_state", jax_create_state)
    # The snapshot is compared in test_torch_port_snapshot.py, at equal weights.
    mp.setattr(jd, "export_train_label_snapshot", lambda *a, **k: {})
    mp.setattr(pd, "make_train_step", recording(pd.make_train_step, "port"))
    mp.setattr(pd, "make_model", port_make_model)
    mp.setattr(pd, "create_state", port_create_state)
    mp.setattr(pd, "make_eval_step", port_eval)
    try:
        jcfg = _config(JaxConfig, root, "jax")
        jres = jd.train_dl("drv", jcfg, *jax_prepare(jcfg))[0]
        pcfg = _config(TrainConfig, root, "port")
        pres = pd.train_dl("drv", pcfg, *prepare_data(pcfg), device="cpu")[0]
        # The port in float64 from the same start: how far each float32 run
        # drifts from it.
        port_dtype["dtype"] = torch.float64
        with pytest.MonkeyPatch.context() as m64:
            m64.setattr(pd, "make_train_step", recording(orig_port_step, "f64"))
            m64.setattr(pd, "export_train_label_snapshot", lambda *a, **k: {})
            fcfg = _config(TrainConfig, root, "f64")
            pres["f64"] = pd.train_dl("drv", fcfg, *prepare_data(fcfg), device="cpu")[0]
        port_dtype["dtype"] = torch.float32
        # Each later epoch once more in both drivers, resumed from JAX's
        # checkpoint of the epoch before it: one shared start an epoch.
        mp.setattr(pd, "make_train_step", recording(orig_port_step, None))
        mp.setattr(jd, "make_train_step", recording(orig_jax_step, None))
        jres["resumed"], pres["resumed"] = [], []
        for epx in (1, 2):
            for cls, drv, prep, runs_, kw in ((JaxConfig, jd, jax_prepare, jres["resumed"], {}),
                                              (TrainConfig, pd, prepare_data, pres["resumed"],
                                               {"device": "cpu"})):
                tag = f"resume{epx}_{drv.__name__.split('.')[0]}"
                shutil.copytree(root / "models_jax" / f"drv_fold0_epx{epx - 1}",
                                root / f"models_{tag}" / f"drv_fold0_epx{epx - 1}")
                rcfg = _config(cls, root, tag).replace(epochs=epx + 1, auto_resume=True)
                runs_.append(drv.train_dl("drv", rcfg, *prep(rcfg), **kw)[0])
    finally:
        mp.undo()
    jres["steps"], pres["steps"] = steps["jax"], steps["port"]
    return root, jres, pres


def _series(res, key):
    return [h[key] for h in res["writer"].history if key in h]


def test_driver_first_step_matches_jax(runs):
    """The first step, before any update: the DP loss within 2e-5 (measured
    3e-6); the class-weighted CE within 1e-3 (measured 2.8e-4, JAX's float32
    sum on the CPU; the port's is within 2e-7 of float64)."""
    _, jres, pres = runs
    assert len(pres["steps"]) == len(jres["steps"]) == 6
    (jl, jce), (pl, pce) = jres["steps"][0], pres["steps"][0]
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
    np.testing.assert_allclose(pce, jce, rtol=1e-3)


def test_driver_losses_match_jax(runs):
    """Per-epoch mean loss (the DP loss), each epoch from the state JAX's
    epoch started at: the first from the shared initial state, each later
    one resumed from JAX's checkpoint of the epoch before.

    Over the three chained epochs both packages drift from a float64 run of
    the port by about 1e-2 relative (JAX -1.2e-2, the port +7.6e-3 in the
    third epoch, `test_driver_float32_drift_against_float64`), in opposite directions: float32 rounding moves batch
    statistics' pre-activations across the ReLU kinks
    (`test_torch_port_bn_gap.py`) and the steps amplify it. From a shared
    start an epoch carries two steps of that noise."""
    _, jres, pres = runs
    want, got = ([_series(res, "losses/loss_fold0")[0]]
                 + [_series(r, "losses/loss_fold0")[-1] for r in res["resumed"]]
                 for res in (jres, pres))
    assert len(got) == len(want) == 3
    assert all(len(_series(r, "losses/loss_fold0")) == 1 for r in jres["resumed"] + pres["resumed"])
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_driver_float32_drift_against_float64(runs):
    """Both float32 drivers over the three chained epochs against the port
    in float64 from the same start, per-epoch mean loss. Measured: JAX
    4.5e-5, 3.4e-3 and -1.2e-2 relative, the port 3.2e-4, 3.8e-3 and
    7.6e-3 (8.5e-3 on four threads). The first epoch, before async BatchNorm takes over, stays within
    1e-3 for both; every epoch within 5e-2: float32's drift, not a fault of
    either."""
    _, jres, pres = runs
    exact = np.array(_series(pres["f64"], "losses/loss_fold0"))
    assert len(exact) == 3 and np.isfinite(exact).all()
    for res in (jres, pres):
        rel = np.array(_series(res, "losses/loss_fold0")) / exact - 1
        print("float32 drift from float64, per epoch:", rel)
        assert abs(rel[0]) <= 1e-3
        assert np.abs(rel).max() <= 5e-2


def test_driver_dice_match_jax(runs):
    """Train and validation Dice per epoch: the argmax flips of near-ties
    move a Dice by at most a few voxels' worth."""
    _, jres, pres = runs
    for key in ("scores/dice_mean_wo_bg_fold0", "scores/val_dice_mean_wo_bg_fold0"):
        want, got = _series(jres, key), _series(pres, key)
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, atol=2e-2, equal_nan=True, err_msg=key)


def test_driver_dp_vector_matches_jax(runs):
    """The final DP vector: rows of the train set moved, the validation row
    did not."""
    _, jres, pres = runs
    want = np.asarray(jres["state"].dp_params)
    got = pres["state"].dp_params.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    train = pres["train_idxs"]
    assert (got[train] != 0).all()
    assert (np.delete(got, train) == 0).all()
    assert pres["state"].step == int(jres["state"].step) == 6
    assert pres["state"].sched_steps == int(jres["state"].sched_steps) == 4  # epochs 0 and 2
    np.testing.assert_array_equal(pres["train_idxs"], jres["train_idxs"])
    np.testing.assert_array_equal(pres["clean_idxs"], jres["clean_idxs"])
    np.testing.assert_allclose(pres["wise_dice"], jres["wise_dice"], rtol=1e-6)
    assert np.isfinite(pres["mean_step_time"])


def test_driver_checkpoints(runs):
    root, _, pres = runs
    for epx in range(3):
        assert (root / "models_port" / f"drv_fold0_epx{epx}" / "state.pt").is_file()
        assert (root / "models_port" / f"drv_fold0_epx{epx}" / "config.json").is_file()
    saved = torch.load(root / "models_port" / "drv_fold0_epx2" / "state.pt", weights_only=True)
    assert saved["step"] == 6 and saved["sched_steps"] == 4
    assert len(saved["optimizer"]["state"]) == len(list(pres["state"].model.parameters()))
    torch.testing.assert_close(saved["dp_params"], pres["state"].dp_params, rtol=0, atol=0)


def test_driver_snapshot(runs):
    """The port's export of the trained run: JAX's nine keys, rows sorted by
    DP, the train rows only, volumes at the x2.0 eval scale."""
    _, _, pres = runs
    snap = load_snapshot(pres["snapshot_path"])
    assert pres["snapshot_path"].name == "train_label_snapshot.npz"
    assert pres["snapshot_path"].parent.name == "drv_fold0_epx2"
    assert sorted(snap) == SNAPSHOT_KEYS
    dp = pres["state"].dp_params.numpy()
    np.testing.assert_array_equal(snap["data_parameters"], np.sort(dp[pres["train_idxs"]]))
    np.testing.assert_array_equal(np.sort(snap["dataset_idxs"]), pres["train_idxs"])
    for k in ("labels", "modified_labels", "train_predictions"):
        assert snap[k].shape == (6, 48, 48, 32) and snap[k].dtype == np.int32, k


def test_corr_helpers_match_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(30)
    b = a * 0.4 + rng.randn(30)
    ties = np.round(b, 1)
    for x, y in ((a, b), (a, ties), (ties, ties)):
        assert pd.pearson_corr(x, y) == pytest.approx(jd.pearson_corr(x, y), rel=1e-12)
        assert pd.spearman_corr(x, y) == pytest.approx(jd.spearman_corr(x, y), rel=1e-12)
    assert np.isnan(pd.pearson_corr(np.ones(4), a[:4]))
    for disturbed in ([3, 7, 11], [], [0]):
        for pos in ("min", "max"):
            np.testing.assert_equal(pd.dp_in_target_pos_ratio(a, disturbed, pos),
                                    jd.dp_in_target_pos_ratio(a, disturbed, pos))


def test_precompute_sample_metrics_matches_jax(runs):
    root, _, _ = runs
    jcfg, pcfg = _config(JaxConfig, root, "jax"), _config(TrainConfig, root, "port")
    jds, _ = jax_prepare(jcfg)
    pds, _ = prepare_data(pcfg)
    idxs = np.arange(1, 8)
    want = jd.precompute_sample_metrics(jds, idxs, 2, False, batch=3)
    got = pd.precompute_sample_metrics(pds, idxs, 2, False, batch=3, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6)
    assert (got[0][idxs, 1] < 1).any()
