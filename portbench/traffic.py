"""The benchmark's inputs, made from the run's seed by one general generator
from a traffic file's parameters (`traffic/<name>.json`).

Two kinds, by the file's "entry":

  * 'train': a synthetic CrossMoDa-shaped dataset on disk, in the layout the
    port's loader reads (an L4 directory of NIfTI pairs and the synthetic
    registration artifact `synthetic_reg.pkl`): `cases` fixed MRI-like
    images with an ellipsoid lesion and a bright rim, and `atlases`
    registered atlas labels each, of which `bad_atlases` are rolled far off
    (and half of those transposed), the others jittered by a voxel.
  * 'eval': a pool of `pool` MRI-like volumes of `raw_size` (a smooth
    background, an ellipsoid lesion, noise), as a NIfTI reader returns them
    (float64).

Every draw is made on the device from one generator in a few large calls,
so a seed gives the same inputs on any run of the same card.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, device, salt: int):
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + salt) % (2**63))
    return g


def write_nifti(path: Path, data: np.ndarray) -> None:
    """A NIfTI-1 file (gzip level 1) of a 3D array: float32, int16 or uint8,
    identity affine."""
    codes = {np.dtype(np.float32): 16, np.dtype(np.int16): 4, np.dtype(np.uint8): 2}
    data = np.asarray(data)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, codes[data.dtype], data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<3f", hdr, 108, 352.0, 1.0, 0.0)  # vox_offset, scl_slope, scl_inter
    struct.pack_into("<2h", hdr, 252, 1, 1)  # qform, sform codes
    struct.pack_into("<12f", hdr, 280, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F"))


def _grid(size, device):
    return [torch.arange(n, dtype=torch.float32, device=device).reshape(
        [-1 if a == k else 1 for a in range(3)]) for k, n in enumerate(size)]


def _ellipsoids(size, centers, radii, device):
    """(N, *size) bool: inside each row's ellipsoid."""
    acc = 0.0
    for k, g in enumerate(_grid(size, device)):
        acc = acc + ((g[None] - centers[:, k].reshape(-1, 1, 1, 1))
                     / radii[:, k].reshape(-1, 1, 1, 1)) ** 2
    return acc <= 1.0


def train_fixture(root, params: dict, seed: int, device):
    """Write the training dataset under `root`; -> dict of the host arrays
    written: "images" (N, *size) float32, "labels" (N, *size) uint8,
    "atlases" (N, A, *size) uint8, "bad" (N, A) bool."""
    size = tuple(int(s) for s in params["size"])
    N, A, nbad = int(params["cases"]), int(params["atlases"]), int(params["bad_atlases"])
    g = _generator(seed, device, 1)
    u = torch.rand((N, 8), generator=g, device=device)
    s = torch.tensor(size, dtype=torch.float32, device=device)
    centers = s / 2 + (u[:, 0:3] - 0.5) * s / 4
    radii = torch.clamp(s / (5.0 + 4.0 * u[:, 3:6]), min=2.0)
    label = _ellipsoids(size, centers, radii, device)
    rim = _ellipsoids(size, centers + 3.0, radii * 1.6, device) & ~label
    gain = (0.8 + 0.4 * u[:, 6]).reshape(-1, 1, 1, 1)
    noise = torch.randn((N, *size), generator=g, device=device)
    images = 0.2 * noise + label * gain + 0.25 * rim
    # Atlases: a coin order per case picks the bad slots; shifts and the
    # transpose coin per atlas.
    slots = torch.rand((N, A), generator=g, device=device).argsort(dim=1)[:, :nbad]
    bad = torch.zeros((N, A), dtype=torch.bool, device=device)
    bad.scatter_(1, slots, True)
    v = torch.rand((N, A, 7), generator=g, device=device)
    good_shift = torch.floor(v[..., 0:3] * 3).long() - 1
    bad_shift = (5 + torch.floor(v[..., 3:6] * 5).long()) * torch.where(v[..., 3:6] < 0.5, -1, 1)
    shift = torch.where(bad[..., None], bad_shift, good_shift).tolist()
    flip = ((v[..., 6] < 0.5) & bad).tolist()
    atlases = torch.empty((N, A, *size), dtype=torch.uint8, device=device)
    lab8 = label.to(torch.uint8)
    for n in range(N):
        for a in range(A):
            out = torch.roll(lab8[n], tuple(shift[n][a]), dims=(0, 1, 2))
            atlases[n, a] = out.transpose(0, 1) if flip[n][a] else out
    host = {"images": images.float().cpu().numpy(), "labels": lab8.cpu().numpy(),
            "atlases": atlases.cpu().numpy(), "bad": bad.cpu().numpy()}

    root = Path(root)
    img_dir = root / "L4_fine_localized_crop" / "target_training_unlabeled"
    lbl_dir = root / "L4_fine_localized_crop" / "__omitted_labels_target_training__"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    registrations = OrderedDict()
    for n in range(N):
        write_nifti(img_dir / f"crossmoda_{n + 1}_hrT2_l.nii.gz", host["images"][n])
        write_nifti(lbl_dir / f"crossmoda_{n + 1}_hrT2_l_Label.nii.gz", host["labels"][n])
        registrations[f"{n + 1}l"] = OrderedDict(
            (f"{100 + a:03d}l", {"warped_label": host["atlases"][n, a],
                                 "is_good": not bool(host["bad"][n, a])})
            for a in range(A))
    with open(root / "synthetic_reg.pkl", "wb") as f:
        pickle.dump({"registrations": registrations,
                     "bad_slots": {f"{n + 1}l": np.flatnonzero(host["bad"][n]).tolist()
                                   for n in range(N)},
                     "size": size}, f, protocol=pickle.HIGHEST_PROTOCOL)
    return host


def eval_volumes(params: dict, seed: int, device) -> np.ndarray:
    """(pool, *raw_size) float64 MRI-like volumes."""
    size = tuple(int(s) for s in params["raw_size"])
    P = int(params["pool"])
    g = _generator(seed, device, 2)
    coarse = torch.randn((P, 1, 9, 9, 9), generator=g, device=device)
    vol = 0.3 * F.interpolate(coarse, size=size, mode="trilinear", align_corners=True)[:, 0]
    u = torch.rand((P, 8), generator=g, device=device)
    s = torch.tensor(size, dtype=torch.float32, device=device)
    centers = s / 2 + (u[:, 0:3] - 0.5) * s / 3
    radii = torch.clamp(s / (6.0 + 6.0 * u[:, 3:6]), min=2.0)
    vol += _ellipsoids(size, centers, radii, device) * (0.8 + 0.4 * u[:, 6]).reshape(-1, 1, 1, 1)
    vol += 0.1 * torch.randn((P, *size), generator=g, device=device)
    return (100.0 + 50.0 * vol).double().cpu().numpy()


class Reservoir:
    """A uniform sample of `size` of a stream whose length is not known
    beforehand, drawn from the seed (reservoir sampling): `offer(position,
    item)` for each item in turn; `kept` maps the sampled positions to
    their items."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng(seed % (2**63))
        self.size = size
        self.kept = {}
        self.seen = 0

    def offer(self, position, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[position] = item
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[position] = item
