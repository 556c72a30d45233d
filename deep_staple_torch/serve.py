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

Runs on `cuda` unless `--device cpu` is given; multi-GPU serving
(`--mesh-data`, `--mesh-space`) comes with a later slice.
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
    if mesh_data > 1 or mesh_space > 1:
        raise NotImplementedError("multi-GPU serving comes with a later slice of the port")
    device = resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model, config, _, num_classes = load_serving_state(checkpoint_dir, device)
    eval_step = make_eval_step(model, config, num_classes, eval_scale_factor=eval_scale)

    path_chunks = [
        input_paths[s : s + batch_size] for s in range(0, len(input_paths), batch_size)
    ]
    if not path_chunks:
        print("served 0 volumes (no inputs)")
        return ServeResult([], 0.0, 0, [])
    pin = device.type == "cuda"

    def _load_chunk(paths):
        vols, metas = [], []
        for p in paths:
            img = load_nifti(p)
            data = img.get_fdata()
            vols.append(preprocess(data, config, size))
            metas.append((Path(p), data.shape, img.affine))
        pad = batch_size - len(vols)
        batch = torch.from_numpy(np.stack(vols + [vols[-1]] * pad))
        return (batch.pin_memory() if pin else batch), metas

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
            pred, _ = eval_step(batch)
            pred_np = pred[: len(chunk_metas)].cpu().numpy()  # the batch's one sync
            batch_ms.append((time.perf_counter() - tb) * 1e3)
            for p, m in zip(pred_np, chunk_metas):
                voxels += int(np.prod(p.shape))
                out_paths.append(write_output(p, m))
    dt = time.perf_counter() - t0
    n = len(out_paths)
    print(f"served {n} volumes in {dt:.2f}s on {device} ({len(path_chunks)} executions, "
          f"{n / max(dt, 1e-9):.3f} volumes/s, {voxels / max(dt, 1e-9) / 1e6:.0f} M voxel/s "
          f"incl. write-out)")
    return ServeResult(out_paths, dt, len(path_chunks), batch_ms)


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
    ap.add_argument("--mesh-data", type=int, default=1, help="multi-GPU: not in this slice")
    ap.add_argument("--mesh-space", type=int, default=1, help="multi-GPU: not in this slice")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    return serve(args.checkpoint, args.inputs, args.output_dir, args.batch_size,
                 args.eval_scale, args.output_space, tuple(args.size), args.mesh_data,
                 args.mesh_space, device=args.device)


if __name__ == "__main__":
    main()
