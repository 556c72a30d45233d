"""Serving over two processes on the CPU (gloo): `python -m
deep_staple_torch.serve --mesh-data 2` under torchrun's environment writes
label maps byte for byte those of one process (`serve.py`)."""

import gzip
import socket
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)
SIZE = (16, 16, 16)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A checkpoint of random weights and 3 volumes (2 batches of 2 at
    --batch-size 4 over 2 ranks, the second padded)."""
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.data.nifti import save_nifti
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.train.checkpoint import save_weights
    from deep_staple_torch.train.driver import make_model

    root = tmp_path_factory.mktemp("serve_dp")
    cfg = TrainConfig(use_checkpointing=False, crop_3d_w_dim_range=None)
    model, _ = make_model(cfg, 2)
    init_weights(model, torch.Generator().manual_seed(4))
    save_weights(root / "ckpt", model, np.zeros(4, np.float32), cfg)
    rng = np.random.RandomState(0)
    inputs = []
    for i in range(3):
        p = root / f"vol{i}.nii.gz"
        save_nifti(p, (rng.rand(20, 18, 14) * 100).astype(np.float32),
                   affine=np.diag([0.5, 0.6, 1.0 + i, 1.0]))
        inputs.append(str(p))
    return root, inputs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _maps(out_dir):
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(out_dir.glob("*_seg.nii.gz"))}


def test_mesh_data_2_writes_the_maps_of_one_process(served):
    from deep_staple_torch.serve import serve

    root, inputs = served
    args = ["--checkpoint", str(root / "ckpt"), "--inputs", *inputs, "--batch-size", "4",
            "--size", *map(str, SIZE), "--device", "cpu", "--mesh-data", "2",
            "--output-dir", str(root / "two")]
    port = _free_port()
    envs = []
    for r in range(2):
        env = R.clean_env()
        env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        envs.append(env)
    ranks = [R.Ranks([[sys.executable, "-m", "deep_staple_torch.serve", *args]], 240, env=e)
             for e in envs]
    try:
        # One process at the ranks' batch size (2 rows a forward), meanwhile.
        one = serve(root / "ckpt", inputs, root / "one", batch_size=2, size=SIZE, device="cpu")
        outs = [r.wait()[0] for r in ranks]
    finally:
        for r in ranks:
            r.kill()
    assert "served 3 volumes" in outs[0] and "rank 0 of 2" in outs[0], outs[0][-2000:]
    assert "served 0 volumes" in outs[1] and "rank 1 of 2" in outs[1], outs[1][-2000:]
    two = _maps(root / "two")
    assert list(two) == [p.name for p in one.paths] and len(two) == 3
    assert two == _maps(root / "one")


def test_mesh_data_needs_a_divisible_batch(served):
    from deep_staple_torch.serve import serve

    root, inputs = served
    with pytest.raises(ValueError, match="divisible by --mesh-data 2"):
        serve(root / "ckpt", inputs, root / "bad", batch_size=3, mesh_data=2, device="cpu")
