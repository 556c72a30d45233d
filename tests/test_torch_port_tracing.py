"""`deep_staple_torch/utils/tracing.py` on the CPU: the off path, spans and
counters when recording, their clock against `torch.profiler`'s, the
attribution of device work to spans, and the spans of `train_dl`, the
train step and the eval step."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.prepare import prepare_data
from deep_staple_torch.train.step import make_eval_step
from deep_staple_torch.utils import tracing

torch.set_num_threads(1)

DRIVER_PHASES = ["train.batch", "train.draws", "train.to_device", "train.step"]
STEP_PHASES = ["step.augment", "step.forward", "step.backward", "step.optimizer",
               "step.dp_pass", "step.dp_optimizer", "step.dice"]
EVAL_PHASES = ["eval.resize", "eval.forward", "eval.argmax", "eval.dice"]


@pytest.fixture
def recorder():
    rec = tracing.record()
    yield rec
    rec.stop()


def _busy(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_off_returns_the_shared_null_context():
    assert tracing.active() is None
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    with a as inside:
        assert inside is None
    tracing.count("n", 3)
    tracing.step(4)
    rec = tracing.record()
    rec.stop()
    assert tracing.active() is None
    assert tracing.span("c") is a
    assert rec.spans == [] and rec.counts == []


def test_spans_nest_with_parents_steps_and_self_time(recorder):
    tracing.step(7)
    with tracing.span("outer"):
        _busy(0.002)
        with tracing.span("inner"):
            _busy(0.004)
        tracing.step(8)
        with tracing.span("inner"):
            _busy(0.004)
    outer, first, second = recorder.spans
    assert [s.name for s in recorder.spans] == ["outer", "inner", "inner"]
    assert outer.parent is None and first.parent is outer and second.parent is outer
    assert (outer.step, first.step, second.step) == (7, 7, 8)
    assert outer.start_ns <= first.start_ns < first.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    s = recorder.summary()["spans"]
    assert set(s) == {"outer", "outer/inner"}
    assert s["outer"]["calls"] == 1 and s["outer/inner"]["calls"] == 2
    assert s["outer/inner"]["total_s"] >= 0.008
    inner_total = sum((x.end_ns - x.start_ns) / 1e9 for x in (first, second))
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["total_s"] - inner_total, abs=1e-9)
    assert 0.002 <= s["outer"]["self_s"] < s["outer"]["total_s"]


def test_counters_add_up_under_their_span(recorder):
    tracing.count("bytes", 5)
    with tracing.span("copy"):
        tracing.count("bytes", 10)
        tracing.count("bytes", 32)
        tracing.count("blocks", 1)
    mid = recorder.now()
    with tracing.span("copy"):
        tracing.count("bytes", 100)
    assert recorder.summary()["counters"] == {"bytes": {"": 5, "copy": 142}, "blocks": {"copy": 1}}
    assert recorder.summary(since=mid)["counters"] == {"bytes": {"copy": 100}}
    assert recorder.summary(until=mid)["spans"]["copy"]["calls"] == 1


def test_span_lies_on_the_profiler_clock(recorder):
    """A span inside a CPU profiler run falls within the profiler's own range
    for the same region, on the shared clock, to 1 ms; no profiler event
    carries the span's name."""
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"region{i}"):
                with tracing.span(f"program.region{i}"):
                    _busy(0.003)
                    (x @ x).relu()
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events()}
    for i, s in enumerate(recorder.spans):
        r = ranges[f"region{i}"]
        lo, hi = ((recorder.unix_ns(t) - start) / 1e3 for t in (s.start_ns, s.end_ns))
        assert r.start - 1000 <= lo <= hi <= r.end + 1000
        assert hi - lo >= 3000
    assert not {s.name for s in recorder.spans} & set(ranges)


def test_attribution_credits_the_innermost_span(recorder):
    with tracing.span("train.step"):
        _busy(0.001)
        with tracing.span("step.forward"):
            _busy(0.002)
        _busy(0.001)
    step, fwd = recorder.spans

    def at(span, frac):
        return recorder.unix_ns(int(span.start_ns + frac * (span.end_ns - span.start_ns)))

    t_fwd, t_step = at(fwd, 0.5), recorder.unix_ns(step.end_ns - 1000)
    before = recorder.unix_ns(step.start_ns - 10**6)
    events = [
        ("launch", 1, t_fwd, t_fwd + 5), ("kernel", 1, t_fwd + 10**6, t_fwd + 3 * 10**6),
        ("launch", 2, t_fwd, t_fwd + 5), ("copy", 2, t_fwd + 10**6, t_fwd + 2 * 10**6),
        ("launch", 3, t_step, t_step + 5), ("kernel", 3, t_step, t_step + 4 * 10**6),
        ("launch", 4, before, before + 5), ("kernel", 4, t_step, t_step + 10**6),
        ("kernel", 5, t_step, t_step + 10**6),  # no launch of its correlation id
    ]
    out = recorder.attribute(events)
    assert out["spans"]["train.step/step.forward"] == {
        "kernel_s": 0.002, "kernels": 1, "copy_s": 0.001, "copies": 1}
    assert out["spans"]["train.step"] == {"kernel_s": 0.004, "kernels": 1, "copy_s": 0.0,
                                          "copies": 0}
    assert out["unattributed"] == {"kernel_s": 0.002, "kernels": 2, "copy_s": 0.0, "copies": 0}


def test_profiler_events_of_a_cpu_run_hold_no_device_work():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(64, 64).sum()
    assert tracing.profiler_events(prof) == []


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    """A tiny strict-OOL `train_dl` (3 epochs of 2 steps) recorded whole,
    with the second epoch profiled; beside it each step's loss and Dice as
    the step returned them and as the driver's readback gave them."""
    root = tmp_path_factory.mktemp("tracing")
    generate_synthetic_crossmoda(root / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    cfg = TrainConfig(dataset="synthetic", reg_state="synthetic",
                      dataset_directory=str(root / "ds"), crop_3d_w_dim_range=None,
                      epochs=3, batch_size=2, num_val_images=1, use_checkpointing=False,
                      save_labels=False, save_every=2, log_jsonl=False,
                      output_dir=str(root / "out"), mdl_save_prefix=str(root / "models"),
                      profile_dir=str(root / "prof"), profile_epoch=1)
    stepped, read = [], []
    make_train_step, read_back = pd.make_train_step, pd._read_back

    def make_step(*a, **k):
        step = make_train_step(*a, **k)

        def run(*aa, **kk):
            state, metrics = step(*aa, **kk)
            stepped.append((float(metrics["loss"]), metrics["dice"].numpy().copy()))
            return state, metrics
        return run

    def reading(pending):
        read.append(read_back(pending))
        return read[-1]

    rec = tracing.record()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pd, "make_train_step", make_step)
            mp.setattr(pd, "_read_back", reading)
            res = pd.train_dl("trc", cfg, *prepare_data(cfg), device="cpu")[0]
    finally:
        rec.stop()
    return root, rec, res, (stepped, read)


def test_driver_records_each_steps_phases_in_order(driver_run):
    _, rec, res, _ = driver_run
    assert res["state"].step == 6
    roots = [s for s in rec.spans if s.parent is None]
    for n in range(6):
        phases = [s.name for s in roots if s.step == n and s.name in DRIVER_PHASES]
        assert phases == DRIVER_PHASES, n
    # Each step's metrics are read after the next step call, the epoch's last
    # after its loop: three epochs of two steps read at steps 1, 1, 3, 3, 5, 5.
    assert [s.step for s in roots if s.name == "train.readback"] == [1, 1, 3, 3, 5, 5]
    for step in (s for s in roots if s.name == "train.step"):
        children = [s for s in rec.spans if s.parent is step]
        assert [c.name for c in children] == STEP_PHASES
        for a, b in zip(children, children[1:]):
            assert step.start_ns <= a.start_ns < a.end_ns <= b.start_ns < b.end_ns <= step.end_ns
    assert [s.name for s in roots if s.name == "train.checkpoint"] == ["train.checkpoint"] * 2
    validation = [s for s in roots if s.name == "train.validation"]
    assert [s.step for s in validation] == [1, 3, 5]
    evals = [s.name for s in rec.spans if s.parent is validation[0]]
    assert evals == EVAL_PHASES  # one validation volume
    assert rec.counts == []  # the CPU path copies nothing to a card
    s = rec.summary()["spans"]
    assert s["train.step"]["calls"] == 6
    assert s["train.step/step.forward"]["calls"] == 6
    assert s["train.step"]["self_s"] < s["train.step"]["total_s"]


def test_driver_reads_each_steps_metrics_back_in_order(driver_run):
    """On the CPU the deferred readback reads the step's own tensors: every
    step's loss and Dice, in the steps' order, and no counter."""
    _, rec, _, (stepped, read) = driver_run
    assert len(read) == len(stepped) == 6
    for (loss, dice), (want_loss, want_dice) in zip(read, stepped):
        assert loss == want_loss
        np.testing.assert_array_equal(dice, want_dice)
    assert not [c for c in rec.counts if c[0] == "readback_waited"]


def test_driver_writes_the_profiled_epochs_spans_into_its_trace(driver_run):
    root, rec, _, _ = driver_run
    trace = json.loads((root / "prof" / "trc_fold0_epx1.trace.json").read_text())
    events = trace["traceEvents"]
    (meta,) = [e for e in events if e.get("args", {}).get("name") == "program"]
    track = [e for e in events if e.get("cat") == "program"]
    assert all(e["pid"] == meta["pid"] for e in track)
    assert {e["args"]["step"] for e in track} == {2, 3}
    names = [e["name"] for e in track]
    assert names.count("train.step") == 2 and names.count("step.forward") == 2
    # On the trace's time base: each step span holds the profiler's ops of
    # its forward, within 1 ms.
    base = int(trace.get("baseTimeNanoseconds", 0))
    first = next(s for s in rec.spans if s.name == "train.step" and s.step == 2)
    (mine,) = [e for e in track if e["name"] == "train.step" and e["args"]["step"] == 2]
    assert mine["ts"] == pytest.approx((rec.unix_ns(first.start_ns) - base) / 1e3, abs=1e-3)
    convs = [e for e in events if e.get("name") == "aten::convolution"
             and mine["ts"] <= e["ts"] <= mine["ts"] + mine["dur"]]
    assert convs
    ops = [e["ts"] for e in events if str(e.get("name", "")).startswith("aten::")]
    assert min(ops) >= mine["ts"] - 1e5  # the epoch starts with this step's batch


def test_driver_profiles_an_epoch_without_a_callers_recorder(tmp_path):
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=2, atlas_count=2, size=(8, 8, 8))
    cfg = TrainConfig(dataset="synthetic", reg_state="synthetic",
                      dataset_directory=str(tmp_path / "ds"), crop_3d_w_dim_range=None,
                      epochs=1, batch_size=2, num_val_images=1, use_checkpointing=False,
                      save_labels=False, log_jsonl=False, output_dir=str(tmp_path / "out"),
                      mdl_save_prefix=str(tmp_path / "models"),
                      profile_dir=str(tmp_path / "prof"), profile_epoch=0)
    pd.train_dl("own", cfg, *prepare_data(cfg), device="cpu")
    assert tracing.active() is None
    trace = json.loads((tmp_path / "prof" / "own_fold0_epx0.trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "program"]
    assert names.count("train.step") == 1 and "step.dp_pass" in names


def test_to_device_counts_what_it_copies_to_a_card(recorder, monkeypatch):
    """The copy to a card, with the pinning and the copy stood in for on the
    CPU: `h2d_bytes` is the host arrays' nbytes, `pinned_allocs` the
    allocator's growth; the CPU path counts nothing."""
    host = {"image": np.zeros((2, 4, 5, 6), np.float32), "label": np.ones((2, 4, 5, 6), np.int32),
            "dataset_idx": np.arange(2)}
    cpu = pd._to_device(host, torch.device("cpu"))
    assert recorder.counts == [] and recorder.spans == []
    assert all(isinstance(v, torch.Tensor) for v in cpu.values())

    allocs = iter([3, 5])
    monkeypatch.setattr(pd, "_pinned_allocs", lambda: next(allocs))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self.clone())
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self.clone())
    with tracing.span("train.to_device"):
        pd._to_device(host, torch.device("cuda"))
    counters = recorder.summary()["counters"]
    assert counters["h2d_bytes"] == {"train.to_device": sum(v.nbytes for v in host.values())}
    assert counters["pinned_allocs"] == {"train.to_device": 2}
    spans = recorder.summary()["spans"]
    assert spans["train.to_device/to_device.pin"]["calls"] == 3
    assert spans["train.to_device/to_device.copy"]["calls"] == 3


def test_eval_step_records_its_four_spans(recorder):
    cfg = TrainConfig(use_checkpointing=False)
    model, _ = pd.make_model(cfg, 2)
    step = make_eval_step(model.eval(), cfg, 2)
    batch = {"image": torch.randn(1, 8, 8, 8), "label": torch.zeros(1, 8, 8, 8, dtype=torch.int32)}
    tracing.step(3)
    pred, dice = step(batch)
    assert pred.shape == (1, 16, 16, 16)
    assert [s.name for s in recorder.spans] == EVAL_PHASES
    assert all(s.parent is None and s.step == 3 for s in recorder.spans)
