"""The JAX package's orbax checkpoints (`state.orbax`) read and written by
the port without orbax or tensorstore (`deep_staple_torch/train/ocdbt.py`,
`zarr2.py`, `orbax_io.py`), on the CPU.

JAX's `save_checkpoint(..., backend='orbax')` writes a test-size state (the
reference-default model, its parameters in bfloat16) and the production
state (`tpu_production`, every float leaf set from a seed, so that its
chunks compress as a trained state's do) with `state.msgpack` beside each.
The port's `read_orbax` must equal its `msgpack_restore` leaf by leaf, bit
for bit; its OCDBT keys and values must equal tensorstore's. The port's
`write_orbax` must restore in JAX (with a template and template-free) to
the JAX state bit for bit. Then the entry points: `train_dl` resumes and
`serve` serves from a directory that holds only JAX's `state.orbax`, as
from its `state.msgpack`; `checkpoint_backend='orbax'` trains and saves on
one rank and on a gloo grid of data 2 x model 2; the stale-file rules; a
damaged store raises. A slow case reads the JAX package's 2-process
`state.orbax` (its multi-host fixture, about 30 s to 2 minutes).
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.serve import load_serving_state as jax_load_serving_state
from deep_staple_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from deep_staple_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from deep_staple_tpu.train.driver import make_model as jax_make_model
from deep_staple_tpu.train.state import create_state as jax_create_state
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.data.nifti import load_nifti, save_nifti
from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
from deep_staple_torch.models.interop import state_to_jax
from deep_staple_torch.serve import serve
from deep_staple_torch.train import driver as pd
from deep_staple_torch.train.checkpoint import (
    checkpoint_exists, restore_checkpoint, save_checkpoint, save_jax_checkpoint,
)
from deep_staple_torch.train.flax_msgpack import msgpack_restore
from deep_staple_torch.train.ocdbt import OcdbtStore
from deep_staple_torch.train.orbax_io import read_orbax, write_orbax
from deep_staple_torch.train.prepare import prepare_data
from deep_staple_torch.train.state import create_state

torch.set_num_threads(1)

STATES = ("test", "production")


def _jax_state(kind: str):
    """(JAX config, state): see the module."""
    if kind == "test":
        cfg = JaxConfig(use_checkpointing=False, crop_3d_w_dim_range=None)
        model, in_ch = jax_make_model(cfg, 2)
        state, _ = jax_create_state(model, (1, 16, 16, 10, in_ch), 5, seed=3)
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), state.params)
        return cfg, state.replace(params=params, step=jnp.asarray(7, jnp.int32))
    cfg = JaxConfig.tpu_production(crop_3d_w_dim_range=None)
    model, in_ch = jax_make_model(cfg, 2)
    state, _ = jax_create_state(model, (1, 16, 16, 16, in_ch), 64, seed=4)
    rng = np.random.RandomState(4)

    def seeded(path, x):
        if not jnp.issubdtype(x.dtype, jnp.floating) or x.ndim == 0:
            return x
        values = rng.randn(*x.shape) * 0.05
        if getattr(path[-1], "key", None) in ("var", "nu"):  # positive where they must be
            values = np.abs(values) + 0.5
        return jnp.asarray(values.astype(np.float32)).astype(x.dtype)
    state = jax.tree_util.tree_map_with_path(seeded, state)
    return cfg, state.replace(step=jnp.asarray(11, jnp.int32))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{kind: (root, JAX config, JAX state)}: root/orbax holds JAX's
    state.orbax, root/msgpack its state.msgpack, of the same state."""
    out = {}
    for kind in STATES:
        root = tmp_path_factory.mktemp(kind)
        cfg, state = _jax_state(kind)
        jax_save_checkpoint(root / "orbax", state, cfg, backend="orbax")
        jax_save_checkpoint(root / "msgpack", state, cfg, backend="msgpack")
        out[kind] = root, cfg, state
    return out


def _assert_trees_bitwise(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_bitwise(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, path
        got, want = got.view(torch.int16).numpy(), want.view(torch.int16).numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("kind", STATES)
def test_read_orbax_equals_msgpack_restore(saved, kind):
    """Every leaf bit for bit, with its dtype and shape, and the empty
    nodes; the production state within 60 s (measured about 0.4 s)."""
    root, _, _ = saved[kind]
    t0 = time.perf_counter()
    got = read_orbax(root / "orbax" / "state.orbax")
    seconds = time.perf_counter() - t0
    want = msgpack_restore((root / "msgpack" / "state.msgpack").read_bytes())
    _assert_trees_bitwise(got, want)
    assert got["opt_state"]["inner_state"]["1"] == {} and got["dp_opt_state"] is not None
    if kind == "test":
        leaf = got["params"]["head"]["Conv_1"]["kernel"]
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    print(f"read_orbax of the {kind} state: {seconds:.3f} s")
    assert seconds <= 60


@pytest.mark.parametrize("kind", STATES)
def test_ocdbt_store_matches_tensorstore(saved, kind):
    """The top-level store and process 0's: the same keys as tensorstore
    lists and the same value bytes."""
    root, _, _ = saved[kind]
    for store in (root / "orbax" / "state.orbax", root / "orbax" / "state.orbax" / "ocdbt.process_0"):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{store}/"}).result()
        want = sorted(k.decode() for k in kv.list().result())
        got = OcdbtStore(store)
        assert got.keys() == want and len(want) > 100
        for key in want:
            assert got.read(key) == kv.read(key).result().value, key


@pytest.mark.parametrize("kind", STATES)
def test_write_orbax_restores_in_jax(saved, kind, tmp_path):
    """The port's state.orbax of the JAX state: JAX's `restore_checkpoint`
    (with the state as template) gives it back bit for bit, and so does
    JAX's template-free serving restore (the production, float32 state:
    `load_serving_state` builds a float32 template). A restore orders every
    dict's keys as JAX's tree functions do, so the trees are compared."""
    root, cfg, state = saved[kind]
    tree = msgpack_restore((root / "msgpack" / "state.msgpack").read_bytes())
    write_orbax(tmp_path / "state.orbax", tree)
    shutil.copy(root / "msgpack" / "config.json", tmp_path / "config.json")
    assert not (tmp_path / "state.orbax" / "manifest.ocdbt").exists()

    def as_tree(s):
        return msgpack_restore(serialization.to_bytes(s))
    _assert_trees_bitwise(as_tree(jax_restore_checkpoint(tmp_path, state)), tree)
    if kind == "production":
        _, _, served, _ = jax_load_serving_state(tmp_path, size=(16, 16, 16))
        _assert_trees_bitwise(as_tree(served), tree)
    _assert_trees_bitwise(read_orbax(tmp_path / "state.orbax"), tree)


def _fixture(tmp_path):
    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(10, 10, 10))


def _base(tmp_path, **kw):
    return dict(dataset="synthetic", reg_state="synthetic", dataset_directory=str(tmp_path / "ds"),
                crop_3d_w_dim_range=None, batch_size=4, num_val_images=1, use_checkpointing=False,
                save_labels=False, log_jsonl=False, output_dir=str(tmp_path / "out"),
                mdl_save_prefix=str(tmp_path / "models"), **kw)


@pytest.mark.parametrize("resume, first_epoch", [
    (dict(auto_resume=True), 2),
    (dict(checkpoint_epx=1), 1),
])
def test_driver_resumes_from_jax_orbax(tmp_path, monkeypatch, resume, first_epoch):
    """A directory with only JAX's `state.orbax` (its `save_checkpoint`)
    resumes in both modes like the same state's `state.msgpack`: the same
    restored state, the same epochs, the same final state bit for bit."""
    _fixture(tmp_path)
    results = {}
    for backend in ("orbax", "msgpack"):
        cfg = TrainConfig(epochs=3, save_every=1, **_base(tmp_path / backend, **resume))
        _fixture(tmp_path / backend)
        dataset, ac = prepare_data(cfg)
        jcfg = JaxConfig.from_dict(cfg.to_dict())
        jm, _ = jax_make_model(jcfg, 2)
        jstate, _ = jax_create_state(jm, (1, 10, 10, 10, 1), len(dataset), seed=5)
        jstate = jstate.replace(step=jstate.step + 7, dp_params=jstate.dp_params + 0.25)
        ckpt = tmp_path / backend / "models" / "jaxrun_fold0_epx1"
        jax_save_checkpoint(ckpt, jstate, jcfg, backend=backend)
        assert sorted(p.name for p in ckpt.iterdir()) == ["config.json", f"state.{backend}"]
        restored = {}
        real_restore = pd.restore_checkpoint

        def recording(path, template, _r=restored, _real=real_restore):
            state = _real(path, template)
            _r["tree"] = state_to_jax(state)
            return state

        monkeypatch.setattr(pd, "restore_checkpoint", recording)
        res = pd.train_dl("jaxrun", cfg, dataset, ac, device="cpu")[0]
        epochs = [h["ref_epoch_idx"] for h in res["writer"].history if "ref_epoch_idx" in h]
        assert epochs == list(range(first_epoch, 3))
        results[backend] = restored["tree"], state_to_jax(res["state"]), jstate
    _assert_trees_bitwise(results["orbax"][0], results["msgpack"][0])
    _assert_trees_bitwise(results["orbax"][1], results["msgpack"][1])
    want = msgpack_restore(serialization.to_bytes(results["orbax"][2]))
    for key in ("params", "batch_stats", "dp_params", "step"):
        _assert_trees_bitwise(results["orbax"][0][key], want[key], key)


def test_serve_from_jax_orbax(saved, tmp_path):
    """`serve` from JAX's `state.orbax` loads the weights and DP vector of
    its `state.msgpack` bit for bit and writes the same maps, byte for
    byte."""
    from deep_staple_torch.serve import load_serving_state

    root, _, _ = saved["production"]
    loaded = [load_serving_state(root / kind, "cpu") for kind in ("orbax", "msgpack")]
    (m_orbax, _, dp_orbax, _), (m_msgpack, _, dp_msgpack, _) = loaded
    assert torch.equal(dp_orbax, dp_msgpack) and dp_orbax.shape == (64,)
    want = m_msgpack.state_dict()
    for k, v in m_orbax.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    rng = np.random.RandomState(4)
    inputs = []
    for i, shape in enumerate([(15, 14, 13), (17, 12, 16)]):
        vol = rng.randn(*shape).astype(np.float32)
        vol += np.linspace(-2, 2, shape[0], dtype=np.float32)[:, None, None]
        inputs.append(str(tmp_path / f"case{i}.nii.gz"))
        save_nifti(inputs[-1], vol, affine=np.diag([1.0, 1.5, 2.0, 1.0]))
    for kind in ("orbax", "msgpack"):
        serve(root / kind, inputs, tmp_path / kind, batch_size=2, size=(16, 16, 16), device="cpu")
    for i in range(2):
        got = load_nifti(tmp_path / "orbax" / f"case{i}_seg.nii.gz")
        want = load_nifti(tmp_path / "msgpack" / f"case{i}_seg.nii.gz")
        assert got.data.shape == want.data.shape
        assert got.data.tobytes() == want.data.tobytes()
        np.testing.assert_array_equal(got.affine, want.affine)


def test_train_dl_saves_orbax_and_resumes(tmp_path):
    """checkpoint_backend='orbax' on one rank: each epoch's directory holds
    `state.orbax` and `config.json` only; JAX restores the last one to the
    port's final state; the port resumes from it bit for bit."""
    _fixture(tmp_path)
    cfg = TrainConfig(epochs=2, save_every=1, checkpoint_backend="orbax", **_base(tmp_path))
    dataset, ac = prepare_data(cfg)
    res = pd.train_dl("orb", cfg, dataset, ac, device="cpu")[0]
    final = state_to_jax(res["state"])
    for epx in range(2):
        d = tmp_path / "models" / f"orb_fold0_epx{epx}"
        assert sorted(p.name for p in d.iterdir()) == ["config.json", "state.orbax"]
    last = tmp_path / "models" / "orb_fold0_epx1"
    jcfg = JaxConfig.from_dict(json.loads((last / "config.json").read_text()))
    jm, _ = jax_make_model(jcfg, 2)
    template, _ = jax_create_state(jm, (1, 10, 10, 10, 1), len(dataset), seed=1)
    restored = jax_restore_checkpoint(last, template)
    _assert_trees_bitwise(msgpack_restore(serialization.to_bytes(restored)), final)
    model, _ = pd.make_model(cfg, 2)
    back = restore_checkpoint(last, create_state(model, len(dataset), seed=9, device="cpu"))
    _assert_trees_bitwise(state_to_jax(back), final)


def test_checkpoint_files_shadowing(tmp_path, monkeypatch):
    """A save removes, once its own file landed, what would shadow it: an
    orbax save the `state.pt` and `state.msgpack`, a `state.pt` save and a
    `save_jax_checkpoint` the `state.orbax`; an orbax write that fails
    leaves the older state in place."""
    cfg = TrainConfig(use_checkpointing=False)
    model, _ = pd.make_model(cfg, 2)
    state = create_state(model, 5, seed=2, device="cpu")
    d = tmp_path / "c"
    save_checkpoint(d, state, cfg)
    save_jax_checkpoint(d, state, cfg)
    assert {p.name for p in d.iterdir()} == {"config.json", "state.pt", "state.msgpack"}
    save_checkpoint(d, state, cfg, backend="orbax")
    assert {p.name for p in d.iterdir()} == {"config.json", "state.orbax"}
    assert checkpoint_exists(d)
    save_checkpoint(d, state, cfg, backend="torch")
    assert {p.name for p in d.iterdir()} == {"config.json", "state.pt"}
    save_checkpoint(d, state, cfg, backend="orbax")
    save_jax_checkpoint(d, state, cfg)
    assert {p.name for p in d.iterdir()} == {"config.json", "state.msgpack"}

    save_checkpoint(d, state, cfg, backend="torch")
    import deep_staple_torch.train.checkpoint as ckpt_mod

    def broken(path, tree):
        (path / "partial").mkdir(parents=True)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "write_orbax", broken)
    with pytest.raises(OSError):
        save_checkpoint(d, state, cfg, backend="orbax")
    assert (d / "state.pt").is_file() and not (d / "state.orbax").exists()


def test_damaged_store_raises(saved, tmp_path):
    """A node with a flipped byte, a truncated manifest, a bad magic and a
    missing data file each raise ValueError naming the file."""
    src = saved["test"][0] / "orbax" / "state.orbax"
    cases = {}
    for case in ("checksum", "truncated", "magic", "missing"):
        cases[case] = tmp_path / case
        shutil.copytree(src, cases[case])
    node = sorted((cases["checksum"] / "d").iterdir())[0]
    data = bytearray(node.read_bytes())
    data[len(data) // 2] ^= 0x10
    node.write_bytes(bytes(data))
    manifest = cases["truncated"] / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-7])
    manifest = cases["magic"] / "manifest.ocdbt"
    manifest.write_bytes(b"\x00" + manifest.read_bytes()[1:])
    for f in (cases["missing"] / "ocdbt.process_0" / "d").iterdir():
        f.unlink()
    for case, match in (("checksum", "bad checksum"), ("truncated", "truncated"),
                        ("magic", "bad magic"), ("missing", "missing OCDBT file")):
        with pytest.raises(ValueError, match=match) as err:
            read_orbax(cases[case])
        assert str(cases[case]) in str(err.value), case


def test_orbax_backend_on_a_data_model_grid(tmp_path):
    """`main` over 4 gloo processes (data 2 x model 2) with
    `--checkpoint-backend orbax`: rank 0 writes each epoch's `state.orbax`,
    gathered to the single-device layout; it restores in one process to
    rank 0's final DP vector and step."""
    import torch_port_ranks as R

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=8, atlas_count=1, size=(16, 16, 16),
                                 seed=5)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--reg-state", "synthetic",
            "--dataset-directory", str(tmp_path / "ds"), "--crop-3d-w-dim-range", "none",
            "--epochs", "2", "--batch-size", "4", "--num-val-images", "2", "--atlas-count", "1",
            "--use-checkpointing", "false", "--ool-mode", "fused", "--save-every", "1",
            "--run-name", "grid", "--checkpoint-backend", "orbax",
            "--output-dir", str(tmp_path / "out"), "--mdl-save-prefix", str(tmp_path / "models"),
            "--mesh-data-axis", "2", "--mesh-model-axis", "2", "--dist-num-processes", "4",
            "--dist-coordinator", f"file://{tmp_path / 'store'}"]
    procs = R.Ranks([[sys.executable, str(R.REPO / "tests" / "torch_port_ranks.py"), "main",
                      str(tmp_path / f"rank{r}.json"), *argv, "--dist-process-id", str(r)]
                     for r in range(4)], timeout=240)
    try:
        procs.wait()
    finally:
        procs.kill()
    rank0 = json.loads((tmp_path / "rank0.json").read_text())
    for epx in range(2):
        d = tmp_path / "models" / f"grid_fold0_epx{epx}"
        assert sorted(p.name for p in d.iterdir()) == ["config.json", "state.orbax"]
    tree = read_orbax(tmp_path / "models" / "grid_fold0_epx1" / "state.orbax")
    np.testing.assert_array_equal(tree["dp_params"], np.asarray(rank0["dp"], np.float32))
    cfg = TrainConfig.from_dict(json.loads(
        (tmp_path / "models" / "grid_fold0_epx1" / "config.json").read_text()))
    model, _ = pd.make_model(cfg, 2)
    state = restore_checkpoint(tmp_path / "models" / "grid_fold0_epx1",
                               create_state(model, len(tree["dp_params"]), seed=1, device="cpu"))
    assert state.step == int(tree["step"]) > 0
    kernel = tree["params"]["head"]["Conv_1"]["kernel"]
    assert kernel.shape[-1] == 2 and np.isfinite(kernel).all()


@pytest.mark.slow
def test_two_process_jax_orbax(tmp_path):
    """The JAX package's 2-process job (`tests/multihost_worker.py`, as
    `tests/test_multihost_e2e.py` runs it; slow there too) saves a
    collective `state.orbax` whose arrays are split over `ocdbt.process_0`
    and `ocdbt.process_1`: the port's OCDBT reader lists and reads what
    tensorstore does, and `read_orbax` gives the DP vector both workers
    printed."""
    import socket
    import subprocess

    from deep_staple_tpu.data.synthetic import generate_synthetic_crossmoda as jax_fixture

    jax_fixture(tmp_path / "fx", num_cases=12, atlas_count=1, size=(16, 16, 16), seed=5)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(repo)
    procs = [subprocess.Popen([sys.executable, str(repo / "tests" / "multihost_worker.py"),
                               str(pid), str(port), str(tmp_path / "fx"), str(tmp_path / "mh")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for pid in (0, 1)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("DP_VECTOR")][-1]
    want_dp = np.array([float(v) for v in line.split()[1:]], np.float32)
    store = tmp_path / "mh" / "models" / "mh-e2e_fold0_epx0" / "state.orbax"
    assert (store / "ocdbt.process_1").is_dir()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{store}/"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    got = OcdbtStore(store)
    assert got.keys() == keys
    for key in keys:
        assert got.read(key) == kv.read(key).result().value, key
    tree = read_orbax(store)
    np.testing.assert_allclose(tree["dp_params"], want_dp, rtol=1e-6, atol=0)
    assert int(tree["step"]) > 0
