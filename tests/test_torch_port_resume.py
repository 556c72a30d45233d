"""Checkpoints and resume of the port's `train_dl` on the CPU (the port's
version of `tests/test_resume.py`, both cases), the checkpoint's whole train
state in each backend, the DP override from a snapshot, label disturbance,
and the options that need processes of their own.

As in the JAX driver (`driver.py:420`, `:434`), a resumed run restarts its
random streams (the augmentation generator and the numpy permutations), so
it continues from the saved state but does not equal an uninterrupted run.
"""

import numpy as np
import pytest
import torch

from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.snapshot_io import load_snapshot
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.checkpoint import (
    checkpoint_exists, restore_checkpoint, restore_weights, save_checkpoint,
)
from deep_staple_torch.train.prepare import prepare_data
from deep_staple_torch.train.state import create_state

torch.set_num_threads(1)


def _base(tmp_path, **kw):
    return dict(
        dataset="synthetic",
        reg_state="synthetic",
        dataset_directory=str(tmp_path / "ds"),
        crop_3d_w_dim_range=None,
        batch_size=4,
        num_val_images=1,
        use_checkpointing=False,
        ool_mode="fused",
        save_labels=False,
        output_dir=str(tmp_path / "out"),
        mdl_save_prefix=str(tmp_path / "models"),
        log_jsonl=False,
        **kw,
    )


def _train(name, cfg):
    return pd.train_dl(name, cfg, *prepare_data(cfg), device="cpu")[0]


def _assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and len(oa["state"]) > 0
    for k in oa["state"]:
        for n in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][k][n], ob["state"][k][n]), (k, n)
    assert torch.equal(a.dp_params, b.dp_params)
    for n in ("mu", "nu", "count"):
        assert torch.equal(getattr(a.dp_opt_state, n), getattr(b.dp_opt_state, n)), n
    assert (a.step, a.sched_steps) == (b.step, b.sched_steps)


def _fresh_state(cfg, n):
    model, _ = pd.make_model(cfg, 2)
    return create_state(model, n, seed=99, device="cpu")


def test_resume_from_checkpoint(tmp_path):
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    base = _base(tmp_path, save_every=1000)
    cfg1 = TrainConfig(epochs=2, **base)
    res1 = _train("resume-test", cfg1)
    dp_after_2 = res1["state"].dp_params.clone()
    ckpt = tmp_path / "models" / "resume-test_fold0_epx1"
    assert checkpoint_exists(ckpt)  # the final checkpoint, written at epx1

    # The checkpoint holds the whole final state, optimizer states included.
    restored = restore_checkpoint(ckpt, _fresh_state(cfg1, len(dp_after_2)))
    _assert_states_equal(restored, res1["state"])
    model, _ = pd.make_model(cfg1, 2)
    assert torch.equal(restore_weights(ckpt, model), dp_after_2)

    # Resume at epoch 1 and train it again.
    cfg2 = TrainConfig(epochs=2, checkpoint_name="resume-test", checkpoint_epx=1, **base)
    state2 = _train("resume-test-b", cfg2)["state"]
    assert state2.step > 0
    assert state2.step == 2 * res1["state"].step - res1["state"].step // 2
    assert not torch.allclose(state2.dp_params, torch.zeros_like(state2.dp_params))
    assert not torch.allclose(state2.dp_params, dp_after_2)


def test_auto_resume_continues_after_newest_checkpoint(tmp_path):
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    base = _base(tmp_path, save_every=1, auto_resume=True)
    # "Interrupted" run: reaches epoch 1 (checkpoints at epx0 and epx1).
    res1 = _train("autoresume", TrainConfig(epochs=2, **base))
    step_after_2 = res1["state"].step
    assert checkpoint_exists(tmp_path / "models" / "autoresume_fold0_epx1")

    # The same command with the full epoch budget continues at epoch 2.
    res2 = _train("autoresume", TrainConfig(epochs=4, **base))
    assert res2["state"].step == 2 * step_after_2
    assert checkpoint_exists(tmp_path / "models" / "autoresume_fold0_epx3")

    # A completed run: auto-resume restores and re-exports, the state unchanged.
    res3 = _train("autoresume", TrainConfig(epochs=4, **base))
    _assert_states_equal(res3["state"], res2["state"])


def test_checkpoint_round_trip_and_backends(tmp_path):
    cfg = TrainConfig(use_checkpointing=False)
    a = _fresh_state(cfg, 5)
    a.step, a.sched_steps = 3, 2
    gen = torch.Generator().manual_seed(0)
    for p in a.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    a.optimizer.step()
    a.dp_params = torch.arange(5, dtype=torch.float32)
    save_checkpoint(tmp_path / "c", a, cfg)
    _assert_states_equal(restore_checkpoint(tmp_path / "c", _fresh_state(cfg, 5)), a)
    save_checkpoint(tmp_path / "o", a, cfg, backend="orbax")
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == ["config.json", "state.orbax"]
    _assert_states_equal(restore_checkpoint(tmp_path / "o", _fresh_state(cfg, 5)), a)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        save_checkpoint(tmp_path / "o", a, cfg, backend="zip")


@pytest.mark.parametrize("kw, match", [
    (dict(mesh_data_axis=2), "launch 2 processes with --dist-num-processes 2"),
    (dict(mesh_model_axis=2), "launch 2 processes with --dist-num-processes 2"),
    (dict(mesh_space_axis=2), "launch 2 processes with --dist-num-processes 2"),
    (dict(dist_num_processes=2), "maybe_init_distributed"),
])
def test_parallel_options_need_their_processes(tmp_path, kw, match):
    """Data, tensor and spatial parallelism run one process a rank: in a
    single process, a data, model or space axis above 1 or a process count
    without a process group raises before any work."""
    cfg = TrainConfig(output_dir=str(tmp_path / "out"), **kw)
    with pytest.raises(ValueError, match=match):
        pd.train_dl("x", cfg, None, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kw", [
    dict(use_2d_normal_to="D"),
    dict(use_mind=True),
    dict(augment_order="fast-int8"),
])
def test_side_path_options_pass_check_supported(kw):
    """The 2D model, MIND features and every augment order are ported: the
    options that raised before slice 5 pass `check_supported`."""
    pd.check_supported(TrainConfig(**kw))


def test_default_device_never_falls_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(output_dir=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pd.train_dl("x", cfg, None)
    assert not (tmp_path / "out").exists()


def test_dp_override_from_snapshot(tmp_path):
    """override_embedding_weights: the DP vector starts from a snapshot's
    values, by id, and stays there (the step skips the DP update)."""
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    base = _base(tmp_path, save_every=1000)
    res1 = _train("first", TrainConfig(epochs=1, **{**base, "save_labels": True}))
    snap = load_snapshot(res1["snapshot_path"])
    cfg = TrainConfig(epochs=1, override_embedding_weights=True,
                      fixed_weight_file=str(res1["snapshot_path"]), **base)
    dataset, ac = prepare_data(cfg)
    want = np.zeros(len(dataset), np.float32)
    ids = dataset.get_3d_ids()
    for _id, w in zip(snap["d_ids"], snap["data_parameters"]):
        want[ids.index(_id)] = w
    assert np.count_nonzero(want) == len(res1["train_idxs"])
    res = pd.train_dl("second", cfg, dataset, ac, device="cpu")[0]
    np.testing.assert_array_equal(res["state"].dp_params.numpy(), want)


def test_disturbance_follows_the_host_stream(tmp_path):
    """disturbed_percentage: the disturbed rows are the reset numpy
    stream's choice among the non-empty train rows (`driver.py:200-215`),
    and their labels are FLIP_ROLL-disturbed."""
    from deep_staple_torch.core.determinism import reset_determinism
    from deep_staple_torch.core.config import LabelDisturbanceMode
    from deep_staple_torch.data.crossmoda import (
        CrossmodaHybridIdDataset, get_crossmoda_data_load_closure,
    )

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=5, atlas_count=2, size=(12, 12, 12))
    closure = get_crossmoda_data_load_closure(
        base_dir=str(tmp_path / "ds"), domain="target", state="l4", use_additional_data=False,
        size=(12, 12, 12), resample=True, normalize=True, crop_3d_w_dim_range=None,
        ensure_labeled_pairs=True, modified_3d_label_override=None, debug=False)
    dataset = CrossmodaHybridIdDataset(closure, size=(12, 12, 12))
    cfg = TrainConfig(**_base(tmp_path, save_every=1000), epochs=1, disturbed_percentage=0.5,
                      disturbance_mode=LabelDisturbanceMode.FLIP_ROLL, disturbance_strength=0.5)
    res = pd.train_dl("dist", cfg, dataset, 1, device="cpu")[0]
    reset_determinism(cfg.seed)
    train = np.arange(1, 5)
    want = np.random.choice(train, size=2, replace=False)
    assert sorted(dataset.disturbed_idxs) == sorted(want.tolist())
    np.testing.assert_array_equal(res["clean_idxs"], np.setdiff1d(train, want))
    for i in want:
        _id = dataset.get_3d_ids()[i]
        assert not np.array_equal(dataset.modified_label_data_3d[_id], dataset.label_data_3d[_id])


@pytest.mark.parametrize("resume, first_epoch", [
    (dict(auto_resume=True), 2),
    (dict(checkpoint_epx=1), 1),
])
def test_jax_msgpack_checkpoint_resumes(tmp_path, monkeypatch, resume, first_epoch):
    """A directory with only the JAX package's `state.msgpack` (written by
    its own `save_checkpoint`) resumes in both modes: the restored state is
    the JAX state bit for bit, and training goes on from the epoch JAX's
    rules give (after the newest checkpoint, or that epoch again)."""
    from flax import serialization

    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from deep_staple_tpu.train.driver import make_model as jax_make_model
    from deep_staple_tpu.train.state import create_state as jax_create_state
    from deep_staple_torch.models.interop import state_to_jax
    from torch_port_state import flat

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    cfg = TrainConfig(epochs=3, **_base(tmp_path, save_every=1), **resume)
    dataset, ac = prepare_data(cfg)
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    jm, _ = jax_make_model(jcfg, 2)
    jstate, _ = jax_create_state(jm, (1, 10, 10, 10, 1), len(dataset), seed=5)
    jstate = jstate.replace(step=jstate.step + 7, sched_steps=jstate.sched_steps + 3,
                            dp_params=jstate.dp_params + 0.25)
    ckpt = tmp_path / "models" / "jaxrun_fold0_epx1"
    jax_save_checkpoint(ckpt, jstate, jcfg)
    restored = {}
    real_restore = pd.restore_checkpoint

    def recording_restore(path, template):
        state = real_restore(path, template)
        restored["path"], restored["tree"] = path, state_to_jax(state)
        return state

    monkeypatch.setattr(pd, "restore_checkpoint", recording_restore)
    res = pd.train_dl("jaxrun", cfg, dataset, ac, device="cpu")[0]
    assert restored["path"] == ckpt
    want = serialization.msgpack_restore((ckpt / "state.msgpack").read_bytes())
    for key in ("params", "batch_stats"):
        got = dict(flat(restored["tree"][key]))
        for path, v in flat(want[key]):
            np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    for key in ("dp_params", "step", "sched_steps"):
        np.testing.assert_array_equal(restored["tree"][key], want[key])
    epochs = [h["ref_epoch_idx"] for h in res["writer"].history if "ref_epoch_idx" in h]
    assert epochs == list(range(first_epoch, 3))
    per_epoch = 1  # 4 training volumes at batch 4
    assert res["state"].step == 7 + per_epoch * len(epochs)
