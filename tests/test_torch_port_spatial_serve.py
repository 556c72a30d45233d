"""Serving over a space axis on the CPU (gloo): `python -m
deep_staple_torch.serve --mesh-space S [--mesh-data D]` under torchrun's
environment, D x S processes, writes label maps byte for byte those of one
process at the data ranks' batch size (`tests/test_serve.py:78-95`): at
12^3, eval x1.0, over space 2 and over data 2 x space 2; at 16^3, eval x2.0,
for a MIND-SSC checkpoint and a 2D-model checkpoint over space 2. Every
group of ranks starts at once, in subprocesses, while this process serves
the references. Then the refusals."""

import gzip
import socket
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)

# name -> (checkpoint, size, eval scale, batch, mesh data, mesh space)
CASES = {
    "space2": ("plain", 12, 1.0, 4, 1, 2),
    "data2-space2": ("plain", 12, 1.0, 2, 2, 2),
    "mind-space2": ("mind", 16, 2.0, 4, 1, 2),
    "2d-space2": ("2d", 16, 2.0, 4, 1, 2),
}


def _balanced(model, cfg, vols, size, scale):
    """Move class 1's bias by the mean margin of the model on the volumes
    as serving prepares them, so that the served maps hold both classes
    (maps of one class would compare nothing)."""
    from deep_staple_torch.ops.resample import interpolate_sample
    from deep_staple_torch.ops.stacking import make_2d_stack_from_3d
    from deep_staple_torch.serve import preprocess
    from deep_staple_torch.train.step import _featurize

    img = torch.from_numpy(np.stack([preprocess(v, cfg, (size,) * 3) for v in vols]))
    img, _ = interpolate_sample(img, None, scale)
    if cfg.use_2d_normal_to is not None:
        img = make_2d_stack_from_3d(img[:, None], cfg.use_2d_normal_to)[:, 0]
    x = _featurize(img, cfg.use_mind, cfg.use_2d_normal_to is not None)
    with torch.no_grad():
        y = model.eval()(x)["out"]
        last = model.head.Conv_1 if hasattr(model, "head") else model.Conv_1
        last.bias[1] += (y[..., 0] - y[..., 1]).mean()
    return model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _maps(out_dir):
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(out_dir.glob("*_seg.nii.gz"))}


def _args(root, case):
    ckpt, size, scale, batch, D, S = CASES[case]
    return ["--checkpoint", str(root / ckpt), "--inputs", *map(str, sorted(root.glob("vol*.nii.gz"))),
            "--size", *[str(size)] * 3, "--eval-scale", str(scale), "--device", "cpu",
            "--batch-size", str(batch)] + (["--mesh-data", str(D)] if D > 1 else []) + \
        ["--mesh-space", str(S), "--output-dir", str(root / case)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Three checkpoints of random weights (3D, 3D on MIND-SSC features, 2D
    normal to D), 3 volumes, and every case's ranks started."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.data.nifti import save_nifti
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.models.lraspp2d import init_weights as init_weights_2d
    from deep_staple_torch.train.checkpoint import save_weights
    from deep_staple_torch.train.driver import make_model

    root = tmp_path_factory.mktemp("serve_space")
    rng = np.random.RandomState(0)
    vols = [(rng.rand(20, 18, 14) * 100).astype(np.float32) for _ in range(3)]
    for i, v in enumerate(vols):
        save_nifti(root / f"vol{i}.nii.gz", v, affine=np.diag([0.5, 0.6, 1.0 + i, 1.0]))
    for name, kw, size, scale in (("plain", {}, 12, 1.0), ("mind", dict(use_mind=True), 16, 2.0),
                                  ("2d", dict(use_2d_normal_to="D"), 16, 2.0)):
        cfg = TrainConfig(use_checkpointing=False, crop_3d_w_dim_range=None, **kw)
        model, _ = make_model(cfg, 2)
        (init_weights_2d if "use_2d_normal_to" in kw else init_weights)(
            model, torch.Generator().manual_seed(4))
        _balanced(model, cfg, vols, size, scale)
        save_weights(root / name, model, np.zeros(4, np.float32), cfg)
    launched = {}
    for case in CASES:
        _, _, _, _, D, S = CASES[case]
        port = _free_port()
        launched[case] = []
        for r in range(D * S):
            env = R.clean_env()
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(D * S),
                       LOCAL_WORLD_SIZE=str(D * S), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            launched[case].append(R.Ranks([[sys.executable, "-m", "deep_staple_torch.serve",
                                            *_args(root, case)]], 240, env=env))
    yield root, launched
    for ranks in launched.values():
        for r in ranks:
            r.kill()


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_space_writes_the_maps_of_one_process(served, case):
    """Rank 0 writes every map, the other ranks none, and the maps are one
    process's at the data ranks' batch, byte for byte, with both classes."""
    from deep_staple_torch.serve import main

    root, launched = served
    ckpt, size, scale, batch, D, S = CASES[case]
    args = _args(root, case)
    one = root / f"{case}-one"
    args[args.index("--batch-size") + 1] = str(batch // D)
    args = args[:args.index("--mesh-space")] + ["--output-dir", str(one)]
    if "--mesh-data" in args:
        i = args.index("--mesh-data")
        del args[i:i + 2]
    main(args)
    outs = [r.wait()[0] for r in launched[case]]
    assert f"serving on a data={D} space={S} device mesh" in outs[0], outs[0][-2000:]
    assert "served 3 volumes" in outs[0] and f"rank 0 of {D * S}" in outs[0], outs[0][-2000:]
    for r, out in enumerate(outs[1:], 1):
        assert "served 0 volumes" in out and f"rank {r} of {D * S}" in out, out[-2000:]
    want, got = _maps(one), _maps(root / case)
    assert len(want) == 3 and list(got) == list(want)
    assert got == want
    fg = [np.frombuffer(m[352:], np.int16) for m in want.values()]  # past the NIfTI header
    assert 0 < sum(int((f > 0).sum()) for f in fg) < sum(f.size for f in fg)


def _serve(root, **kw):
    from deep_staple_torch.serve import serve

    return serve(root / "plain", sorted(root.glob("vol*.nii.gz")), root / "refused",
                 device="cpu", **kw)


def test_mesh_space_refusals(served, monkeypatch):
    """JAX's checks first, with its messages (`deep_staple_tpu/serve.py:
    93-106`): the batch over --mesh-data, H over --mesh-space; then the
    port's: D x S processes, and a row of the model's coarsest grid a space
    rank. Each before any rank joins."""
    root, _ = served
    with pytest.raises(ValueError, match="--batch-size 3 must be divisible by --mesh-data 2"):
        _serve(root, batch_size=3, mesh_data=2, mesh_space=2)
    with pytest.raises(ValueError, match="volume H axis 12 must be divisible by --mesh-space 5"):
        _serve(root, size=(12, 12, 12), mesh_space=5)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        _serve(root, batch_size=2, mesh_data=2, mesh_space=2)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _serve(root, mesh_space=2)
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="fewer than the 8 ranks"):
        _serve(root, size=(16, 16, 16), eval_scale=1.0, mesh_space=8)
    assert not torch.distributed.is_initialized()


def test_training_over_a_space_axis_still_refused(tmp_path, monkeypatch):
    """Training over a space axis runs (the name is from when it was
    refused): a sharded model runs a train-mode forward (on a group of one
    rank of a space axis of 1, which exchanges nothing) and returns its
    slab, and `check_supported` takes `mesh_space_axis` given D x S x M
    processes."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models.lraspp3d import MobileNetLRASPP3D, attach_space_group
    from deep_staple_torch.parallel.mesh import SpaceGroup
    from deep_staple_torch.train import driver

    monkeypatch.setattr(driver, "_world_size", lambda: 8)
    driver.check_supported(TrainConfig(mesh_data_axis=2, mesh_space_axis=2, mesh_model_axis=2,
                                       output_dir=str(tmp_path)))
    model = attach_space_group(MobileNetLRASPP3D(use_checkpointing=False), SpaceGroup(0, 1))
    y = model(torch.zeros(1, 8, 8, 8, 1), train=True, generator=torch.Generator())["out"]
    assert y.shape == (1, 8, 8, 8, 2) and y.requires_grad
