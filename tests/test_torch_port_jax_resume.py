"""The JAX driver's fold checkpoints resumed by the port's driver, on the
CPU: JAX's `train_dl` writes `state.msgpack` each epoch, and the port's
`train_dl` with auto_resume and more epochs restores the newest, bit for
bit, and trains on from the epoch after it, as JAX's auto_resume does
(`deep_staple_tpu/train/driver.py:304-320`). The step itself is held to
JAX's in `test_torch_port_jax_checkpoint.py`.
"""

from pathlib import Path

import numpy as np
import torch

from flax import serialization

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.train import driver as jd
from deep_staple_tpu.train.prepare import prepare_data as jax_prepare
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.models.interop import state_to_jax
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.prepare import prepare_data
from torch_port_state import flat

torch.set_num_threads(1)


def test_train_dl_resumes_from_jax_fold_checkpoints(tmp_path, monkeypatch):
    """JAX's `train_dl` writes a checkpoint each epoch (save_every 1); the
    port's `train_dl` with auto_resume and more epochs restores the newest,
    JAX's final state bit for bit, and trains on from the epoch after it,
    as JAX's auto_resume does (`deep_staple_tpu/train/driver.py:304-320`)."""
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))
    common = dict(dataset="synthetic", reg_state="synthetic",
                  dataset_directory=str(tmp_path / "ds"), crop_3d_w_dim_range=None,
                  compute_dtype="float32", bn_warmup_epochs=0, batch_size=4, num_val_images=1, save_every=1,
                  save_labels=False, log_jsonl=False, mdl_save_prefix=str(tmp_path / "models"))
    jcfg = JaxConfig.tpu_production(epochs=2, output_dir=str(tmp_path / "out_jax"), **common)
    monkeypatch.setattr(jd, "export_train_label_snapshot", lambda *a, **k: {})
    jstate = jd.train_dl("mix", jcfg, *jax_prepare(jcfg))[0]["state"]
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == [
        "mix_fold0_epx0", "mix_fold0_epx1"]
    assert not list((tmp_path / "models").glob("*/state.pt"))

    restored = {}
    real_restore = pd.restore_checkpoint

    def recording_restore(path, template):
        state = real_restore(path, template)
        restored["path"], restored["tree"] = Path(path), state_to_jax(state)
        return state

    monkeypatch.setattr(pd, "restore_checkpoint", recording_restore)
    pcfg = TrainConfig.tpu_production(epochs=3, auto_resume=True,
                                      output_dir=str(tmp_path / "out_port"), **common)
    res = pd.train_dl("mix", pcfg, *prepare_data(pcfg), device="cpu")[0]
    assert restored["path"].name == "mix_fold0_epx1"
    want = serialization.msgpack_restore(
        (tmp_path / "models" / "mix_fold0_epx1" / "state.msgpack").read_bytes())
    for key in ("params", "batch_stats"):
        got_leaves = dict(flat(restored["tree"][key]))
        for path, v in flat(want[key]):
            np.testing.assert_array_equal(got_leaves[path], v, err_msg="/".join(path))
    np.testing.assert_array_equal(restored["tree"]["dp_params"], want["dp_params"])
    assert int(restored["tree"]["step"]) == int(jstate.step)
    epochs = [h["ref_epoch_idx"] for h in res["writer"].history if "ref_epoch_idx" in h]
    assert epochs == [2]
    assert res["state"].step == int(jstate.step) + int(jstate.step) // 2
    assert (tmp_path / "models" / "mix_fold0_epx2" / "state.pt").is_file()
