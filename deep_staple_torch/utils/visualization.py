"""Segmentation figures on the host: alpha-composited overlay grids and the
DP diagnostic scatter.

The port's copy of `deep_staple_tpu/utils/visualization.py`:
`visualize_seg` renders image / segmentation / ground-truth overlays of 2D
or 3D samples or batches with per-tile captions, frames (disturb markers),
crop-to-nonzero and a class colour map, to a PNG and as an RGB array;
`save_parameter_figure` is the DP scatter (`main_deep_staple.py:297-316`).
Inputs are numpy arrays (the DP vector copied from the card).

matplotlib draws the colour maps and the scatter, PIL the captions and the
PNG. Where either is missing, the call raises ImportError naming it; unlike
the JAX package, no figure falls back to a fixed palette or drops its
captions or file, so a figure is the same wherever it is drawn.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def require_plotting(what: str = "the figures", modules=("matplotlib", "PIL")):
    """Raise ImportError naming matplotlib or PIL where one is missing (also
    a check made before work whose end draws figures)."""
    for mod in modules:
        try:
            importlib.import_module(mod)
        except ImportError as e:
            raise ImportError(f"{what} need {mod}, which is not installed here") from e


def _pyplot():
    require_plotting(modules=("matplotlib",))
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def get_cmap_dict(class_max_id: int, pyplot_map_name: str = "gist_rainbow",
                  no_color_zero_id: bool = True) -> dict:
    """Discretized pyplot colour map, e.g. {0: None, 1: (r, g, b), ...}
    (reference `visualization.py:226-264`): `cmap(i / num_ids)` for i in
    0..num_ids-1, scaled to 0-255; id 0 maps to None (transparent) when
    `no_color_zero_id`."""
    cmap = _pyplot().get_cmap(pyplot_map_name)
    cmap_dict: dict = {}
    if no_color_zero_id:
        cmap_dict[0] = None
        num_ids, id_offset = class_max_id, 1
    else:
        num_ids, id_offset = class_max_id + 1, 0
    discretized = (cmap(np.arange(num_ids) / float(num_ids)) * 255).astype(np.int32)
    for idx, rgba in enumerate(discretized):
        cmap_dict[idx + id_offset] = tuple(int(v) for v in rgba[:3])
    return cmap_dict


def _palette_from_cmap(color_map: Optional[dict], max_id: int) -> np.ndarray:
    """(max_id+1, 3) uint8 lookup table from a cmap dict (None entries -> 0);
    without one, the pyplot map of the largest class id (reference
    :428-430)."""
    if color_map is None:
        color_map = get_cmap_dict(max(int(max_id), 1))
    table = np.zeros((max_id + 1, 3), np.uint8)
    for cls, rgb in color_map.items():
        if rgb is not None and 0 <= int(cls) <= max_id:
            table[int(cls)] = np.asarray(rgb, np.uint8)
    return table


def _to_uint8_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def _overlay(base_rgb: np.ndarray, lbl: np.ndarray, alpha: float,
             palette: np.ndarray) -> np.ndarray:
    lbl = np.asarray(lbl).astype(np.int64)
    color = palette[np.clip(lbl, 0, len(palette) - 1)].astype(np.float32)
    mask = (lbl > 0)[..., None].astype(np.float32) * alpha
    return (base_rgb.astype(np.float32) * (1 - mask) + color * mask).astype(np.uint8)


def _reduce_slice_index(axis: int, labels: Sequence[Optional[np.ndarray]],
                        extent: int) -> int:
    """One 2D slice index for a tile: the centre of the nonzero extent of the
    first label volume that has one, else the middle slice; image, seg and
    ground truth share it, so the overlays stay aligned."""
    for lbl in labels:
        if lbl is None:
            continue
        other = tuple(a for a in range(lbl.ndim) if a != axis)
        nz = np.flatnonzero(np.any(np.asarray(lbl) > 0, axis=other))
        if nz.size:
            return int((nz.min() + nz.max()) // 2)
    return extent // 2


def _crop_to_nonzero(arrs: Sequence[np.ndarray], ref: np.ndarray, margin: int = 2):
    nz = np.argwhere(np.asarray(ref) > 0)
    if nz.size == 0:
        return arrs
    lo = np.maximum(nz.min(0) - margin, 0)
    hi = nz.max(0) + margin + 1
    sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    return [a[sl] for a in arrs]


def visualize_seg(
    in_type: str,
    img=None,
    seg=None,
    ground_truth=None,
    reduce_dim: Optional[str] = None,
    crop_to_non_zero_seg: bool = False,
    crop_to_non_zero_gt: bool = False,
    alpha_seg: float = 0.4,
    alpha_gt: float = 0.2,
    onehot_color_map: Optional[dict] = None,
    n_per_row: int = 8,
    overlay_text: Optional[Sequence[str]] = None,
    annotate_color=(0, 255, 255),
    frame_elements: Optional[Sequence[bool]] = None,
    file_path=None,
):
    """Render overlay tiles. in_type in {'single_2D', 'single_3D',
    'batch_2D', 'batch_3D'} (reference `visualize_seg`,
    visualization.py:280-481).

    img: grayscale volume(s) (may include a leading channel dim of 1);
    seg / ground_truth: int labels. Returns the composed RGB grid (H, W, 3)
    and writes it to `file_path` when given.
    """
    if in_type not in ("single_2D", "single_3D", "batch_2D", "batch_3D"):
        raise ValueError(f"unknown in_type {in_type!r}")
    is_batch = in_type.startswith("batch")
    is_3d = in_type.endswith("3D")
    if is_3d and reduce_dim not in ("D", "H", "W"):
        raise ValueError("3D input needs reduce_dim 'D', 'H' or 'W'")
    require_plotting("visualize_seg", modules=("PIL",))
    from PIL import Image, ImageDraw

    def _listify(x):
        if x is None:
            return None
        x = np.asarray(x)
        if is_batch:
            return [np.squeeze(e) for e in x]
        return [np.squeeze(x)]

    imgs, segs, gts = _listify(img), _listify(seg), _listify(ground_truth)
    n = max(len(x) for x in (imgs, segs, gts) if x is not None)
    max_id = max(
        [int(np.asarray(a).max()) for x in (segs, gts) if x is not None for a in x]
        or [1]
    )
    palette = _palette_from_cmap(onehot_color_map, max(max_id, 1))

    tiles = []
    for i in range(n):
        im = imgs[i] if imgs is not None else None
        sg = segs[i] if segs is not None else None
        gt = gts[i] if gts is not None else None

        if is_3d:
            ref3d = sg if (crop_to_non_zero_seg and sg is not None) else (
                gt if (crop_to_non_zero_gt and gt is not None) else None
            )
            if ref3d is not None:
                group = [a for a in (im, sg, gt) if a is not None]
                cropped = _crop_to_nonzero(group, ref3d)
                it = iter(cropped)
                im = next(it) if im is not None else None
                sg = next(it) if sg is not None else None
                gt = next(it) if gt is not None else None
            axis = {"D": 0, "H": 1, "W": 2}[reduce_dim]
            extent = next(a.shape[axis] for a in (im, sg, gt) if a is not None)
            idx = _reduce_slice_index(axis, (sg, gt), extent)
            im = np.take(im, idx, axis=axis) if im is not None else None
            sg = np.take(sg, idx, axis=axis) if sg is not None else None
            gt = np.take(gt, idx, axis=axis) if gt is not None else None

        shape = next(a.shape for a in (im, sg, gt) if a is not None)
        base = _to_uint8_gray(im) if im is not None else np.zeros(shape, np.uint8)
        rgb = np.stack([base] * 3, -1)
        if gt is not None:
            rgb = _overlay(rgb, gt, alpha_gt, palette)
        if sg is not None:
            rgb = _overlay(rgb, sg, alpha_seg, palette)
        if frame_elements is not None and i < len(frame_elements) and frame_elements[i]:
            # A 2-pixel annotate_color outline (the reference's is 1 pixel,
            # visualization.py:467-475).
            rgb[[0, 1, -2, -1], :] = annotate_color
            rgb[:, [0, 1, -2, -1]] = annotate_color
        text = overlay_text[i] if overlay_text is not None and i < len(overlay_text) else None
        tiles.append((rgb, text))

    # The grid, tiles padded to a common size.
    th = max(t[0].shape[0] for t in tiles)
    tw = max(t[0].shape[1] for t in tiles)
    rows = int(np.ceil(len(tiles) / n_per_row))
    grid = np.zeros((rows * th, min(len(tiles), n_per_row) * tw, 3), np.uint8)
    for i, (rgb, text) in enumerate(tiles):
        r, c = divmod(i, n_per_row)
        canvas = np.zeros((th, tw, 3), np.uint8)
        canvas[: rgb.shape[0], : rgb.shape[1]] = rgb
        if text:
            pim = Image.fromarray(canvas)
            ImageDraw.Draw(pim).text((2, 2), str(text), fill=tuple(annotate_color))
            canvas = np.asarray(pim)
        grid[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = canvas

    if file_path is not None:
        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(grid).save(file_path)
    return grid


def save_parameter_figure(_path, title, text, parameters, reweighted_parameters, dices):
    """DP diagnostic scatter (reference `main_deep_staple.py:297-316`): bare
    and reweighted data parameters coloured by the oracle Dice."""
    plt = _pyplot()
    parameters = np.asarray(parameters)
    reweighted = np.asarray(reweighted_parameters)
    fig, axs = plt.subplots(1, 2, figsize=(12, 4), dpi=80)
    style = dict(s=1, cmap="plasma", vmin=0.0, vmax=1.0)
    axs[0].scatter(range(len(parameters)), parameters, c=dices, **style)
    sc2 = axs[1].scatter(range(len(reweighted)), reweighted, c=dices, **style)
    fig.suptitle(title, fontsize=14)
    fig.text(0, 0, text)
    axs[0].set_title("Bare parameters")
    axs[1].set_title("Reweighted parameters")
    axs[0].set_ylim(-10, 10)
    axs[1].set_ylim(-3, 1)
    plt.colorbar(sc2)
    Path(_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(_path)
    plt.clf()
    plt.close()
