"""The port's two-stage GPipe (`deep_staple_torch/parallel/pipeline.py`) on
the CPU, both stages on the CPU device, after `tests/test_parallel.py:
339-645`: the stage split, the GPipe runner against sequential gradient
accumulation on the unsplit model and the pipelined train step against the
fused one, in float64 at JAX's bounds; the pipelined step against JAX's
fused step in float32; and the driver with `mesh_pipe_stages=2` against one
stage.
"""

import copy
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models import MobileNetLRASPP3D, init_weights
from deep_staple_torch.parallel.pipeline import (
    GPipe2, make_pp_train_step, merge_variables, split_variables,
)
from deep_staple_torch.train.losses import _nll, dp_loss_fn
from deep_staple_torch.train.optim import set_lr, sparse_adam_update
from deep_staple_torch.train.state import create_state
from deep_staple_torch.train.step import make_train_step

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
B, BASE, N = 4, (12, 12, 8), 16
CW = np.array([0.5, 1.5], np.float32)
FW = np.full((N,), 5.0, np.float32)


def _model(seed=2, dtype=torch.float64, **kw):
    model = MobileNetLRASPP3D(num_classes=2, use_checkpointing=kw.pop("use_checkpointing", False),
                              **kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dtype)


def _ce(logits, labels):
    return F.cross_entropy(logits.movedim(-1, 1), labels.long())


def _assert_close_norm(got, want, what):
    """Norm-relative with a tiny atol: BN biases right before the next
    normalization have mathematically zero gradients (JAX's gate)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach(), b.detach()
        d = float((a - b).abs().max())
        assert d <= 1e-9 + 1e-6 * float(b.abs().max()), f"{what}: tensor {i} diff {d}"


def test_split_merge_round_trip():
    """Stage state dicts are key slices of the model's, as JAX's stage
    variables are of its variables: the same split on both sides."""
    from deep_staple_tpu.parallel.pipeline import split_variables as jax_split
    from deep_staple_torch.models.interop import state_dict_to_flax
    from deep_staple_torch.parallel.pipeline import PipelineStage0, PipelineStage1

    model = _model(dtype=torch.float32)
    sd = model.state_dict()
    sd0, sd1 = split_variables(sd)
    assert not set(sd0) & set(sd1) and set(sd0) | set(sd1) == set(sd)
    merged = merge_variables(sd0, sd1)
    assert list(merged) == list(sd)
    model.load_state_dict(merged, strict=True)
    assert list(PipelineStage0(model).state_dict()) == list(sd0)
    assert list(PipelineStage1(model).state_dict()) == list(sd1)
    flax = state_dict_to_flax(sd)
    j0, j1 = jax_split(flax)
    for mine, theirs in ((sd0, j0), (sd1, j1)):
        for col in ("params", "batch_stats"):
            assert set(state_dict_to_flax(mine)[col]) == set(theirs[col])


@pytest.mark.parametrize("n_micro", [1, 2])
def test_gpipe_matches_sequential_accumulation(n_micro):
    """GPipe2's loss and gradients equal sequential accumulation on the
    unsplit model (float64, dropout on, the same generator); the stages
    compose to the model's train forward exactly; a pipelined train step
    equals AdamW on the unsplit parameters from the same gradients."""
    model = _model(dropout_rate=0.5)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 12, 12, 8, 1))
    labels = torch.from_numpy(rng.randint(0, 2, (4, 12, 12, 8)))
    ref_model = copy.deepcopy(model)
    pipe = GPipe2(model, CPU2)

    # The stages compose to the train-mode forward (on copies: train mode
    # updates BatchNorm statistics).
    comp = copy.deepcopy(model)
    with torch.no_grad():
        p = GPipe2(comp, CPU2)
        out_s = p.stage1(*p.stage0(x[:2], True), tuple(x.shape[1:4]), True,
                         torch.Generator().manual_seed(3))
        out_f = copy.deepcopy(model)(x[:2], train=True,
                                     generator=torch.Generator().manual_seed(3))["out"]
    assert float((out_s - out_f).abs().max()) < 1e-12

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss, grads = pipe.loss_and_grads(_ce, x, labels, torch.Generator().manual_seed(3),
                                          n_micro)
    # The BatchNorm semantics warning comes with real microbatches only.
    assert any("parallel-accumulation" in str(w.message) for w in caught) == (n_micro > 1)
    gen = torch.Generator().manual_seed(3)
    params = [q for q in ref_model.parameters()]
    m = 4 // n_micro
    tot_l, tot_g = 0.0, None
    for i in range(n_micro):
        li = _ce(ref_model(x[i * m:(i + 1) * m], train=True, generator=gen)["out"],
                 labels[i * m:(i + 1) * m]) / n_micro
        gi = torch.autograd.grad(li, params)
        tot_l += float(li.detach())
        tot_g = list(gi) if tot_g is None else [a + b for a, b in zip(tot_g, gi)]
    np.testing.assert_allclose(float(loss), tot_l, rtol=2e-5)
    _assert_close_norm(grads, tot_g, "gradients")

    # One pipelined train step against AdamW on the unsplit parameters.
    start = copy.deepcopy(model)
    opt = torch.optim.AdamW(model.parameters(), lr=0.01)
    pipe.train_step(opt, _ce, x, labels, torch.Generator().manual_seed(3), n_micro)
    ref_opt = torch.optim.AdamW(start.parameters(), lr=0.01)
    for q, g in zip(start.parameters(), grads):
        q.grad = g
    ref_opt.step()
    _assert_close_norm(list(model.parameters()), list(start.parameters()), "AdamW step")


def _batch64():
    rng = np.random.RandomState(0)
    return {
        "image": torch.from_numpy(rng.randn(B, *BASE)),
        "label": torch.from_numpy((rng.rand(B, *BASE) > 0.8).astype(np.int32)),
        "modified_label": torch.from_numpy((rng.rand(B, *BASE) > 0.8).astype(np.int32)),
        "dataset_idx": torch.arange(B, dtype=torch.int32),
    }


def _state64(cfg):
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.optim import SparseAdamState

    model, _ = make_model(cfg, 2)
    state = create_state(model, N, seed=0, device="cpu")
    model.double()
    state.dp_params = state.dp_params.double()
    o = state.dp_opt_state
    state.dp_opt_state = SparseAdamState(o.mu.double(), o.nu.double(), o.count)
    return model, state


def _assert_states_match(sa, sb, what):
    for (k, a), b in zip(sa.model.state_dict().items(), sb.model.state_dict().values()):
        d = float((a.double() - b.double()).abs().max())
        assert d <= 2e-4, f"{what}: {k} diff {d}"
    np.testing.assert_allclose(sa.dp_params.numpy(), sb.dp_params.numpy(), atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("ool, bn", [("fused", "batch"), ("strict", "batch"), ("strict", "async")])
def test_pp_train_step_matches_fused_step(ool, bn):
    """`make_pp_train_step` with n_micro 1 against `make_train_step` on the
    same state, float64, dropout on with the same generator: metrics at rtol
    2e-5, parameters and BatchNorm statistics at atol 2e-4, the DP vector at
    1e-5 (`tests/test_parallel.py:468-560`)."""
    cfg = TrainConfig(use_checkpointing=False, ool_mode=ool, bn_mode=bn)
    model_r, state_r = _state64(cfg)
    model_p, state_p = _state64(cfg)
    sr, mr = make_train_step(model_r, cfg, CW, FW, augment=False)(
        state_r, _batch64(), 0.01, generator=torch.Generator().manual_seed(0))
    sp, mp = make_pp_train_step(model_p, cfg, CW, FW, augment=False, n_micro=1, devices=CPU2)(
        state_p, _batch64(), 0.01, generator=torch.Generator().manual_seed(0))
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(float(mp[k]), float(mr[k]), rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(mp["dice"].numpy(), mr["dice"].numpy(), rtol=1e-6, equal_nan=True)
    _assert_states_match(sr, sp, f"pp vs fused ({ool}, bn={bn})")
    assert sp.step == 1


def test_pp_train_step_two_microbatches_matches_sequential_accumulation():
    """n_micro 2 (fused): per-microbatch gradients over the batch's CE
    denominator, summed; BatchNorm statistics the mean of the microbatches'
    updates from the same start; one AdamW step; the DP pass over the
    concatenated logits (`tests/test_parallel.py:562-645`)."""
    cfg = TrainConfig(use_checkpointing=False, ool_mode="fused")
    model_p, state_p = _state64(cfg)
    model_r, state_r = _state64(cfg)
    batch = _batch64()
    with pytest.warns(UserWarning, match="parallel-accumulation"):
        sp, mp = make_pp_train_step(model_p, cfg, CW, FW, augment=False, n_micro=2,
                                    devices=CPU2)(state_p, batch, 0.01,
                                                  generator=torch.Generator().manual_seed(0))

    cw = torch.as_tensor(CW)
    img, mod = batch["image"], batch["modified_label"]
    w = cw[mod.long()]
    denom = w.sum()
    gen = torch.Generator().manual_seed(0)
    params = list(model_r.parameters())
    start = {k: v.clone() for k, v in model_r.named_buffers()}
    tot_l, tot_g, logits, stats = 0.0, None, [], []
    for i in range(2):
        sl = slice(2 * i, 2 * i + 2)
        with torch.no_grad():
            for k, v in model_r.named_buffers():
                v.copy_(start[k])
        out = model_r(img[sl][..., None], train=True, generator=gen)["out"]
        li = (_nll(out, mod[sl]) * w[sl]).sum() / denom
        gi = torch.autograd.grad(li, params)
        tot_l += float(li.detach())
        tot_g = list(gi) if tot_g is None else [a + b for a, b in zip(tot_g, gi)]
        logits.append(out.detach())
        stats.append({k: v.clone() for k, v in model_r.named_buffers()})
    with torch.no_grad():
        for k, v in model_r.named_buffers():
            v.copy_((stats[0][k].double() + stats[1][k].double()) / 2)
    for q, g in zip(params, tot_g):
        q.grad = g
    set_lr(state_r.optimizer, 0.01)
    state_r.optimizer.step()
    idxs = batch["dataset_idx"].long()
    dp_vec = state_r.dp_params.clone().requires_grad_(True)
    dp_loss = dp_loss_fn(torch.cat(logits), mod, dp_vec[idxs], torch.as_tensor(FW).double()[idxs])
    (dp_g,) = torch.autograd.grad(dp_loss, [dp_vec])
    touched = torch.zeros(N, dtype=torch.bool)
    touched[idxs] = True
    state_r.dp_params, _ = sparse_adam_update(state_r.dp_params, dp_g, state_r.dp_opt_state,
                                              touched, cfg.lr_inst_param)

    np.testing.assert_allclose(float(mp["ce_loss"]), tot_l, rtol=2e-5)
    np.testing.assert_allclose(float(mp["dp_loss"]), float(dp_loss.detach()), rtol=2e-5)
    _assert_states_match(sp, state_r, "pp n_micro=2 vs sequential accumulation")


def test_pp_train_step_matches_jax_fused_step():
    """The pipelined step (n_micro 1, float32, augmentation off, dropout 0)
    against JAX's fused single-device step from the same weights: CE and DP
    losses at rtol 2e-4."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.models.interop import state_dict_to_flax
    from deep_staple_torch.train.driver import make_model

    cfg = TrainConfig(use_checkpointing=False, ool_mode="fused")
    model, _ = make_model(cfg, 2)
    model.aspp.dropout_rate = 0.0
    state = create_state(model, N, seed=0, device="cpu")
    variables = state_dict_to_flax(model.state_dict())
    batch = {k: v.float() if v.is_floating_point() else v for k, v in _batch64().items()}
    _, mp = make_pp_train_step(model, cfg, CW, FW, augment=False, devices=CPU2)(
        state, batch, 0.01, generator=torch.Generator().manual_seed(0))

    tx = joptim.make_model_optimizer(0.01)
    params = jax.tree.map(jnp.asarray, variables["params"])
    dp0 = jnp.zeros(N, jnp.float32)
    jstate = JaxState(
        step=jnp.zeros((), jnp.int32), sched_steps=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), dp_params=dp0, dp_opt_state=joptim.sparse_adam_init(dp0))
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0)
    jstep = jax_make_train_step(jm, tx, JaxConfig(use_checkpointing=False, ool_mode="fused"),
                                CW, FW, augment=False)
    _, jm_ = jstep(jstate, {k: v.numpy() for k, v in batch.items()}, 0.01, jax.random.PRNGKey(0))
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(float(mp[k]), float(jm_[k]), rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(mp["dice"].numpy(), np.asarray(jm_["dice"]), atol=1e-3,
                               equal_nan=True)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """train_dl on JAX's mesh-driver fixture (6 cases x 2 atlases at 16^3,
    `tests/test_parallel.py:207-249`), 1 epoch at batch 8: one stage, and
    two stages with 1 and 2 microbatches."""
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.driver import train_dl
    from deep_staple_torch.train.prepare import prepare_data

    root = tmp_path_factory.mktemp("ppsynth")
    generate_synthetic_crossmoda(root, num_cases=6, atlas_count=2, bad_atlases_per_case=1,
                                 size=(16, 16, 16), seed=0)

    def run(stages, n_micro):
        tag = f"{stages}x{n_micro}"
        cfg = TrainConfig(
            dataset="synthetic", reg_state="synthetic", dataset_directory=str(root),
            crop_3d_w_dim_range=None, epochs=1, batch_size=8, num_val_images=2,
            use_checkpointing=False, ool_mode="fused", save_every=1000, save_labels=False,
            log_jsonl=False, output_dir=str(root / f"out{tag}"),
            mdl_save_prefix=str(root / f"models{tag}"),
            mesh_pipe_stages=stages, pipe_microbatches=n_micro)
        dataset, atlas_count = prepare_data(cfg)
        return train_dl(f"pp{tag}", cfg, dataset, atlas_count, device="cpu")[0]

    with pytest.warns(UserWarning, match="parallel-accumulation"):
        two_micro = run(2, 2)
    return run(1, 1), run(2, 1), two_micro


def _epoch_loss(res):
    h = [r for r in res["writer"].history if "losses/loss_fold0" in r]
    assert len(h) == 1
    return h[0]["losses/loss_fold0"]


def test_driver_pipeline_matches_one_stage(driver_runs):
    """`mesh_pipe_stages=2`, 1 microbatch, against one stage
    (`tests/test_parallel.py:286-335`): the epoch loss at rtol 5e-4, the DP
    vector at atol 1e-3 with the same signs; validation ran on the model
    placed back on stage 0's device."""
    res1, res_pp, _ = driver_runs
    np.testing.assert_allclose(_epoch_loss(res_pp), _epoch_loss(res1), rtol=5e-4)
    dp1, dppp = res1["state"].dp_params.numpy(), res_pp["state"].dp_params.numpy()
    t = res1["train_idxs"]
    np.testing.assert_allclose(dppp, dp1, atol=1e-3)
    assert np.all(np.sign(dp1[t]) == np.sign(dppp[t])) and np.all(dppp[t] != 0)
    v = [r for r in res_pp["writer"].history if "scores/val_dice_mean_wo_bg_fold0" in r]
    assert v and np.isfinite(v[0]["scores/val_dice_mean_wo_bg_fold0"])


def test_driver_pipeline_two_microbatches_trains(driver_runs):
    """With 2 microbatches the BatchNorm statistics differ by design
    (parallel accumulation), so the run is held to what it must do: a
    finite loss, every trained DP row moved and no other."""
    res1, _, res2 = driver_runs
    assert np.isfinite(_epoch_loss(res2))
    dp = res2["state"].dp_params.numpy()
    t = res1["train_idxs"]
    assert np.all(dp[t] != 0) and np.all(np.delete(dp, t) == 0)


@pytest.mark.parametrize("kw", [
    dict(mesh_pipe_stages=3),
    dict(mesh_pipe_stages=2, mesh_data_axis=2),
    dict(mesh_pipe_stages=2, use_2d_normal_to="D"),
    dict(mesh_pipe_stages=2, batch_size=8, pipe_microbatches=3),
    dict(mesh_pipe_stages=2, use_ool_dp_loss=False),
])
def test_config_pipeline_checks_match_jax(kw):
    """`TrainConfig`'s pipeline checks raise as JAX's do, with its messages
    (`deep_staple_tpu/core/config.py:209-242`)."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig

    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        TrainConfig(**kw)
    assert str(got.value) == str(want.value)
