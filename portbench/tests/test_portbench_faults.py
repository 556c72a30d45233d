"""A whole run at a tiny size on the CPU, with the look for a card skipped
and the timed path broken underneath, must come out not correct: once for
each fault a cell can have. Training: a step that returns its state
unchanged, from the first step or from the window's step on (after an
async-BatchNorm configuration's warm-up); half of each batch left out, the mean taken over the rest.
Serving: an answer altered where it is produced; half of each batch's
answers left out. (No cell spans several cards: no exchange to leave out.)
The limits are the cells' own (`limits/<cell>.json`)."""

from __future__ import annotations

import argparse
import copy

import pytest
import torch

from portbench import run as prun


def _run(root, cell):
    args = argparse.Namespace(workload=cell, seed=2**31 + 101, seconds=1.0, trace=0)
    return prun.run(args, root, device=torch.device("cpu"))


@pytest.mark.parametrize("cell", ["train-prod-b8", "train-ref-b8", "eval-prod-b4",
                                  "eval-ref-b4"])
def test_sound_run_is_correct(tiny_root, cell):
    """The same tiny runs unbroken come out correct: the faults below are
    what fails them."""
    assert _run(tiny_root, cell)["correct"] is True


def _state_unchanged(make):
    def factory(*a, **k):
        step = make(*a, **k)

        def run(state, batch, lr, generator=None, draws=None):
            before = (copy.deepcopy(state.model.state_dict()),
                      copy.deepcopy(state.optimizer.state_dict()),
                      state.dp_params.clone(), state.dp_opt_state, state.step)
            state, metrics = step(state, batch, lr, generator=generator, draws=draws)
            state.model.load_state_dict(before[0])
            state.optimizer.load_state_dict(before[1])
            state.dp_params, state.dp_opt_state, state.step = before[2:]
            return state, metrics

        return run

    return factory


def _half_batch(make):
    def factory(*a, **k):
        step = make(*a, **k)

        def run(state, batch, lr, generator=None, draws=None):
            half = {key: v[: len(v) // 2] for key, v in batch.items()}
            draws = type(draws)(*(d[: len(d) // 2] for d in draws))
            return step(state, half, lr, generator=generator, draws=draws)

        return run

    return factory


def _window_state_unchanged(make):
    """The state left unchanged from the window's step on: the async step
    alone, where an async-BatchNorm configuration warms up through a slab
    BatchNorm step that stays sound."""
    broken = _state_unchanged(make)

    def factory(model, *a, **k):
        modes = {getattr(m, "bn_mode", None) for m in model.modules()}
        return (make if "slab" in modes else broken)(model, *a, **k)

    return factory


@pytest.mark.parametrize("cell", ["train-prod-b8", "train-ref-b8"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _window_state_unchanged])
def test_train_fault(tiny_root, monkeypatch, cell, fault):
    from deep_staple_torch.train import driver

    monkeypatch.setattr(driver, "make_train_step", fault(driver.make_train_step))
    assert _run(tiny_root, cell)["correct"] is False


def _altered(pred):
    pred = pred.clone()
    pred[:, : pred.shape[1] // 2] = 1 - pred[:, : pred.shape[1] // 2]
    return pred


def _half_answers(pred):
    pred = pred.clone()
    pred[len(pred) // 2:] = 0
    return pred


@pytest.mark.parametrize("cell", ["eval-prod-b4", "eval-ref-b4"])
@pytest.mark.parametrize("fault", [_altered, _half_answers])
def test_eval_fault(tiny_root, monkeypatch, cell, fault):
    from deep_staple_torch.train import step as step_mod

    make = step_mod.make_eval_step

    def factory(*a, **k):
        eval_step = make(*a, **k)

        def run(batch):
            pred, dice = eval_step(batch)
            return fault(pred), dice

        return run

    monkeypatch.setattr(step_mod, "make_eval_step", factory)
    assert _run(tiny_root, cell)["correct"] is False
