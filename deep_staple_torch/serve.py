"""Batch segmentation serving from a checkpoint, on the card.

`python -m deep_staple_torch.serve --checkpoint <dir> --inputs a.nii.gz ... \
    --output-dir out/ [--device cpu]`

The port of `deep_staple_tpu/serve.py`: load a checkpoint once (`config.json`
with the port's `state.pt` or the JAX package's `state.msgpack`,
`train/checkpoint.py`), preprocess each NIfTI volume like the
CrossMoDa training pipeline (resample -> pad -> W-crop -> z-normalise), run
the eval forward at the reference's x2.0 eval scale, take the argmax, and
write each label map back onto its input's voxel grid (nearest resize, the
inverse of the prep chain) with the source affine.

Inputs go in fixed-size batches (the last one padded). A loader thread reads
and preprocesses batch k+1 while the card runs batch k; the batch is copied
host -> device from pinned memory without blocking, and the prediction comes
back with one `.cpu()` per batch, which is also the only synchronisation.
Peak host memory is two batches, whatever the number of inputs.

Runs on `cuda` unless `--device cpu` is given.

`--mesh-data D --mesh-space S` serves on D x S ranks, one a device: start
D x S processes under `torchrun --nproc-per-node D*S` (its `RANK`,
`WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`; JAX's serve CLI has no
launch flags either). JAX serves the same mesh in one process over D x S
devices; here each device is a process, rank (d * S + s)
(`parallel/mesh.py::make_grid`). Each batch's rows split over the D data
ranks (the batch size divides by D), and the S ranks of a space group load
the same rows and split each volume's H axis at the eval scale
(`parallel/spatial.py`): each keeps its slab of every activation and reads
its neighbours' halo rows. The slabs are gathered over the space group,
then the rows over the data group, and rank 0 writes. Eval uses
BatchNorm's running statistics, so the maps are those of one process run
at the data ranks' batch size.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .core.config import TrainConfig
from .core.device import resolve_device
from .data.crossmoda import _prep_volume
from .data.nifti import load_nifti, save_nifti
from .data.np_ops import resize_nd_np
from .parallel.multihost import init_distributed
from .train.checkpoint import load_config, restore_weights
from .train.driver import make_model
from .train.step import make_eval_step


class ServeResult(NamedTuple):
    paths: list  # written label maps, in input order
    seconds: float  # wall time of the batch loop, write-out included
    executions: int  # eval forwards run
    batch_ms: list  # per batch: host -> device copy to prediction on the host


def load_serving_state(checkpoint_dir, device=None):
    """-> (model on `device` in eval mode, config, DP vector, num_classes).

    The DP-vector length comes from the checkpoint itself, so a checkpoint
    restores without its dataset; the vector is None for a JAX run without
    data parameters. A directory of the JAX package is read as its
    `load_serving_state` reads it (`deep_staple_tpu/serve.py:49-70`).
    """
    device = resolve_device(device)
    config = load_config(checkpoint_dir)
    num_classes = 2
    model, _ = make_model(config, num_classes=num_classes)
    dp_params = restore_weights(checkpoint_dir, model)
    return model.to(device).eval(), config, dp_params, num_classes


def preprocess(volume, config: TrainConfig, size=(128, 128, 128)):
    return _prep_volume(
        volume, size, resample=True,
        crop_3d_w_dim_range=config.crop_3d_w_dim_range, is_label=False, normalize=True,
    )


def serve(checkpoint_dir, input_paths, output_dir, batch_size: int = 4,
          eval_scale: float = 2.0, output_space: str = "input",
          size=(128, 128, 128), mesh_data: int = 1, mesh_space: int = 1,
          device=None) -> ServeResult:
    size = tuple(size)
    world = data = space = None
    if mesh_data > 1 or mesh_space > 1:
        world, data, space = _join_serving_ranks(mesh_data, mesh_space, batch_size, size,
                                                 eval_scale, device)
        device = world.device
        print(f"serving on a data={mesh_data} space={mesh_space} device mesh", flush=True)
    device = resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model, config, _, num_classes = load_serving_state(checkpoint_dir, device)
    eval_step = make_eval_step(model, config, num_classes, eval_scale_factor=eval_scale,
                               space=space)

    path_chunks = [
        input_paths[s : s + batch_size] for s in range(0, len(input_paths), batch_size)
    ]
    if not path_chunks:
        print("served 0 volumes (no inputs)")
        return ServeResult([], 0.0, 0, [])
    pin = device.type == "cuda"
    # This rank's rows of each batch: all of them on one process.
    rows = range(batch_size) if data is None else range(batch_size)[data.rows(batch_size)]

    def _load_chunk(paths):
        # The batch is padded with copies of its last volume.
        idx = [min(i, len(paths) - 1) for i in rows]
        loaded = {}
        for j in dict.fromkeys(idx):
            img = load_nifti(paths[j])
            vol = img.get_fdata()
            loaded[j] = (preprocess(vol, config, size), (Path(paths[j]), vol.shape, img.affine))
        batch = torch.from_numpy(np.stack([loaded[j][0] for j in idx]))
        return (batch.pin_memory() if pin else batch), [loaded[j][1] for j in idx]

    write_output = _make_output_writer(output_dir, config, size, eval_scale, output_space)
    out_paths, batch_ms = [], []
    voxels = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_load_chunk, path_chunks[0])
        for i in range(len(path_chunks)):
            host_batch, chunk_metas = fut.result()
            if i + 1 < len(path_chunks):
                fut = ex.submit(_load_chunk, path_chunks[i + 1])
            tb = time.perf_counter()
            image = host_batch.to(device, non_blocking=True)
            batch = {"image": image, "label": torch.zeros(image.shape, dtype=torch.int32, device=device)}
            pred, _ = eval_step(batch)  # the space group's slabs gathered
            n_real = len(path_chunks[i])
            if data is not None and (space is None or space.rank == 0):
                pred, chunk_metas = _gather_batch(pred, chunk_metas, path_chunks[i], data)
            pred_np = pred[:n_real].cpu().numpy()  # the batch's one sync
            batch_ms.append((time.perf_counter() - tb) * 1e3)
            if world is not None and world.rank != 0:
                continue  # rank 0 writes
            for p, m in zip(pred_np, chunk_metas[:n_real]):
                voxels += int(np.prod(p.shape))
                out_paths.append(write_output(p, m))
    dt = time.perf_counter() - t0
    n = len(out_paths)
    ranks = "" if world is None else f", rank {world.rank} of {world.size}"
    print(f"served {n} volumes in {dt:.2f}s on {device}{ranks} ({len(path_chunks)} executions, "
          f"{n / max(dt, 1e-9):.3f} volumes/s, {voxels / max(dt, 1e-9) / 1e6:.0f} M voxel/s "
          f"incl. write-out)")
    return ServeResult(out_paths, dt, len(path_chunks), batch_ms)


def _join_serving_ranks(mesh_data: int, mesh_space: int, batch_size: int, size, eval_scale,
                        device):
    """The D x S ranks of `--mesh-data D --mesh-space S` from torchrun's
    environment -> (the world's group, the data group, the space group),
    either None where its axis is 1. JAX's checks first, with its messages
    (`deep_staple_tpu/serve.py:93-106`), then the port's: the processes,
    and a row of the model's coarsest grid for every space rank."""
    import os

    from .parallel.mesh import make_data_group, make_grid
    from .parallel.spatial import slab_map

    if batch_size % mesh_data:
        raise ValueError(f"--batch-size {batch_size} must be divisible by --mesh-data {mesh_data}")
    if mesh_space > 1 and size[1] % mesh_space:
        raise ValueError(f"volume H axis {size[1]} must be divisible by --mesh-space {mesh_space}")
    n = mesh_data * mesh_space
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world != n:
        raise ValueError(
            f"--mesh-data {mesh_data} x --mesh-space {mesh_space} serves on {n} processes, one a "
            f"device, and this run has {world}: launch it with torchrun --nproc-per-node {n} "
            "(RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment)")
    if mesh_space > 1:
        slab_map(int(size[1] * eval_scale), mesh_space)  # raises for too many shards
    if torch.distributed.is_initialized():
        group = make_data_group(resolve_device(device))
    else:
        group = init_distributed(device=device)
    data, _, space = make_grid(group.device, 1, mesh_space)
    return group, data, space


def _gather_batch(pred, metas, paths, data):
    """Every rank's rows of the batch's predictions, with each row's input
    shape and affine (-> the batch's metas in row order, on every rank)."""
    info = torch.tensor([[*m[1], *np.asarray(m[2], np.float64).ravel()] for m in metas],
                        dtype=torch.float64, device=pred.device)
    pred, info = data.gather_rows(pred), data.gather_rows(info).cpu().numpy()
    metas = [(Path(paths[min(i, len(paths) - 1)]), tuple(int(v) for v in row[:3]),
              row[3:].reshape(4, 4)) for i, row in enumerate(info)]
    return pred, metas


def _make_output_writer(output_dir, config, size, eval_scale, output_space):
    def _write_output(pred, meta):
        path, orig_shape, affine = meta
        if output_space == "input":
            # Invert the prep chain: nearest-resize the eval-scale prediction
            # back onto the original voxel grid. The W-crop region outside
            # [crop_lo, crop_hi) is background by construction.
            crop = config.crop_3d_w_dim_range
            at_size_w = (crop[1] - crop[0]) if crop else size[-1]
            pred_model = resize_nd_np(
                pred.astype(np.float32), (*size[:-1], at_size_w), mode="nearest"
            )
            full = np.zeros(size, np.float32)
            if crop:
                full[..., crop[0] : crop[1]] = pred_model
            else:
                full = pred_model
            out = resize_nd_np(full, orig_shape, mode="nearest").astype(np.int16)
        else:
            # Eval-grid output: rescale the affine (column scales and the
            # half-voxel shift of the align_corners=False centre mapping, plus
            # the W-crop offset) so the header stays geometrically correct.
            out = pred.astype(np.int16)
            affine = np.array(affine, np.float64)
            crop = config.crop_3d_w_dim_range
            scales = [orig_shape[a] / size[a] / eval_scale for a in range(3)]
            new_aff = affine.copy()
            shift = np.zeros(3)
            for a in range(3):
                new_aff[:3, a] = affine[:3, a] * scales[a]
                shift += affine[:3, a] * (0.5 * scales[a] - 0.5)
            if crop:
                shift += affine[:3, 2] * (crop[0] * orig_shape[2] / size[2])
            new_aff[:3, 3] = affine[:3, 3] + shift
            affine = new_aff
        out_path = output_dir / (path.name.replace(".nii.gz", "").replace(".nii", "") + "_seg.nii.gz")
        save_nifti(out_path, out, affine=affine)
        print(f"  {path.name} -> {out_path.name} (fg voxels: {int((out > 0).sum())})")
        return out_path

    return _write_output


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="directory with config.json and state.pt or JAX's state.msgpack")
    ap.add_argument("--inputs", nargs="+", required=True, help="input NIfTI volumes")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--eval-scale", type=float, default=2.0,
                    help="reference eval pre-interpolation (HybridIdLoader.py:336)")
    ap.add_argument("--output-space", choices=("input", "eval"), default="input")
    ap.add_argument("--size", type=int, nargs=3, default=(128, 128, 128),
                    help="canonical training volume size (L4 default)")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="serve on N ranks, one a device, under torchrun --nproc-per-node N")
    ap.add_argument("--mesh-space", type=int, default=1,
                    help="split each volume's H axis over S ranks (with --mesh-data D: D x S "
                         "ranks under torchrun --nproc-per-node D*S)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        return serve(args.checkpoint, args.inputs, args.output_dir, args.batch_size,
                     args.eval_scale, args.output_space, tuple(args.size), args.mesh_data,
                     args.mesh_space, device=args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
