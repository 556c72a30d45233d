"""The registration toolbox: keypoints, graphs, filters, SSD cost volumes,
min-convolutions and the affine registration that makes atlas labels.

The counterpart of `deep_staple_tpu/ops/registration.py` (after the
non-MIND parts of the reference's `mindssc.py:20-247`), function for
function and in the same arithmetic order: normalized <-> world keypoint and
flow conversions, random keypoints on a mask, kNN and LBP graphs, separable
1D filters, Gaussian and mean smoothing, pairwise distances, SSD cost
volumes over a displacement window, min-convolutions, and
`affine_register`, the multi-resolution SSD affine estimator that
`tools/register.py::estimate_pullback_lps` calls.

None of it is a kernel of the port: JAX computes all of it outside any
Pallas kernel. The SSD cost volume's correlation is one grouped
`F.conv3d` (JAX: `conv_general_dilated` with `feature_group_count`);
`affine_register` runs its Adam loop on the card by default, with no host
sync inside a scale's loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .grid_sample import grid_sample_3d
from .resample import resize_nd


def _whd(shape, device=None):
    D, H, W = shape
    return torch.tensor([W, H, D], dtype=torch.float32, device=device)


def kpts_pt(kpts_world, shape, align_corners=None):
    """World (z, y, x)-ordered voxel coordinates -> normalized (x, y, z) in
    [-1, 1] (reference :20-29)."""
    s = _whd(shape, kpts_world.device)
    out = (torch.flip(kpts_world, (-1,)) / (s - 1)) * 2 - 1
    if not align_corners:
        out = out * (s - 1) / s
    return out


def kpts_world(kpts_pt_, shape, align_corners=None):
    s = _whd(shape, kpts_pt_.device)
    k = kpts_pt_
    if not align_corners:
        k = k / ((s - 1) / s)
    return torch.flip(((k + 1) / 2) * (s - 1), (-1,))


def flow_pt(flow_world, shape, align_corners=None):
    s = _whd(shape, flow_world.device)
    out = (torch.flip(flow_world, (-1,)) / (s - 1)) * 2
    if not align_corners:
        out = out * (s - 1) / s
    return out


def flow_world(flow_pt_, shape, align_corners=None):
    s = _whd(shape, flow_pt_.device)
    f = flow_pt_
    if not align_corners:
        f = f / ((s - 1) / s)
    return torch.flip((f / 2) * (s - 1), (-1,))


def random_kpts(mask, d: int, num_points=None, generator: torch.Generator | None = None):
    """Normalized keypoints of the nonzero voxels of mask (1, 1, D, H, W) on a
    stride-d grid (reference :72-81) -> (1, N, 3). With `num_points` and a
    `generator`, a random subset of that many, drawn from the generator (JAX
    draws it from a PRNG key)."""
    _, _, D, H, W = mask.shape
    sub = mask[0, 0, ::d, ::d, ::d]
    kpts = torch.nonzero(sub > 0).float()[None]
    if num_points is not None and generator is not None:
        perm = torch.randperm(kpts.shape[1], generator=generator, device=generator.device)
        kpts = kpts[:, perm[:num_points].to(kpts.device)]
    return kpts_pt(kpts, (D // d, H // d, W // d))


def pdist(x, p: int = 2):
    """Pairwise (squared, for p = 2) distances within a point set (B, N, C)
    (reference :160-168)."""
    if p == 1:
        return torch.sum(torch.abs(x[:, :, None] - x[:, None, :]), dim=3)
    xx = torch.sum(x ** 2, dim=2)[:, :, None]
    dist = xx + xx.transpose(1, 2) - 2.0 * torch.einsum("bnc,bmc->bnm", x, x)
    idx = torch.arange(x.shape[1], device=x.device)
    dist[:, idx, idx] = 0
    return dist


def pdist2(x, y, p: int = 2):
    if p == 1:
        return torch.sum(torch.abs(x[:, :, None] - y[:, None, :]), dim=3)
    xx = torch.sum(x ** 2, dim=2)[:, :, None]
    yy = torch.sum(y ** 2, dim=2)[:, None, :]
    return xx + yy - 2.0 * torch.einsum("bnc,bmc->bnm", x, y)


def knn_graph(kpts, k: int, include_self: bool = False):
    """(indices (B, N, k), masked distances, adjacency) of the kNN graph,
    symmetrized (reference :85-95)."""
    B, N, _ = kpts.shape
    dist = pdist(kpts)
    k_eff = k + (1 - int(include_self))
    ind = torch.topk(-dist, k_eff, dim=-1).indices
    ind = ind[:, :, 1 - int(include_self):]
    A = torch.zeros((B, N, N), dtype=kpts.dtype, device=kpts.device)
    rows = torch.arange(N, device=kpts.device).repeat_interleave(ind.shape[2])
    cols = ind.reshape(B, -1)
    A[:, rows, cols[0]] = 1.0
    A[:, cols[0], rows] = 1.0
    return ind, dist * A, A


def lbp_graph(kpts_fixed, k: int):
    """Edge list (E, 2) and each edge's reverse-edge index for loopy belief
    propagation (reference :99-108)."""
    A = knn_graph(kpts_fixed, k, include_self=False)[2][0]
    edges = torch.nonzero(A > 0)
    n = A.shape[0]
    edge_idx = torch.zeros((n, n), dtype=torch.int64, device=A.device)
    edge_idx[edges[:, 0], edges[:, 1]] = torch.arange(edges.shape[0], device=A.device)
    return edges, edge_idx[edges[:, 1], edges[:, 0]]


def filter1d(img, weight, dim: int, padding_mode: str = "replicate"):
    """Separable 1D filter along spatial dim `dim` of (B, C, D, H, W), 'same'
    size, replicate or zero padding (reference :113-125)."""
    n = weight.shape[0]
    pad = n // 2
    axis = dim + 2
    if padding_mode == "replicate":
        size = img.shape[axis]
        first = img.narrow(axis, 0, 1).expand(*img.shape[:axis], pad, *img.shape[axis + 1:])
        last = img.narrow(axis, size - 1, 1).expand(*img.shape[:axis], pad, *img.shape[axis + 1:])
        img = torch.cat([first, img, last], dim=axis)
    else:
        zeros = img.new_zeros(*img.shape[:axis], pad, *img.shape[axis + 1:])
        img = torch.cat([zeros, img, zeros], dim=axis)
    out = 0.0
    L = img.shape[axis] - 2 * pad
    for i in range(n):
        out = out + weight[i] * img.narrow(axis, i, L)
    return out


def smooth(img, sigma: float):
    """Gaussian smoothing, a separable filter of odd width ceil(1.5 sigma) *
    2 + 1 (reference :129-142)."""
    n = int(math.ceil(sigma * 3.0 / 2.0)) * 2 + 1
    xs = np.linspace(-(n // 2), n // 2, n)
    w = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    w = torch.from_numpy((w / w.sum()).astype(np.float32)).to(img.device)
    for dim in (0, 1, 2):
        img = filter1d(img, w, dim)
    return img


def mean_filter(img, r: int):
    w = torch.full((2 * r + 1,), 1.0 / (2 * r + 1), dtype=torch.float32, device=img.device)
    for dim in (0, 1, 2):
        img = filter1d(img, w, dim)
    return img


def _offsets(radius: int, step: int, device):
    """(n^3, 3) (z, y, x) voxel offsets -radius*step .. radius*step, float32."""
    offs = torch.arange(-radius, radius + 1, device=device) * step
    oz, oy, ox = torch.meshgrid(offs, offs, offs, indexing="ij")
    return torch.stack([oz, oy, ox], -1).reshape(-1, 3).float()


def ssd_cost_volume(kpts_fixed, feat_fixed, feat_moving, orig_shape,
                    disp_radius: int = 16, disp_step: int = 2, patch_radius: int = 3):
    """SSD cost volume over a displacement window around each keypoint
    (reference :183-221) -> (1, N, w, w, w), w = 2 * disp_radius + 1.

    kpts_fixed (1, N, 3) normalized (align_corners=True), features (1, C, D,
    H, W). For each keypoint a fixed patch P and a moving search window S;
    cost(d) = sum over the patch of (P - S_d)^2 = -2 <P, S_d> + |P|^2 +
    |S_d|^2, averaged over the patch; the correlation is one grouped conv over
    the C * N (channel, keypoint) pairs."""
    D, H, W = orig_shape
    C = feat_fixed.shape[1]
    N = kpts_fixed.shape[1]
    dev = kpts_fixed.device
    patch_r = patch_radius // disp_step  # the patch's half-size in steps
    pw = 2 * patch_r + 1
    dw = 2 * disp_radius + 1
    sw = dw + 2 * patch_r  # the search window with the patch's margin

    win_pt = flow_pt(_offsets(disp_radius + patch_r, disp_step, dev), (D, H, W),
                     align_corners=True).reshape(1, 1, -1, 1, 3)
    patch_pt = flow_pt(_offsets(patch_r, disp_step, dev), (D, H, W),
                       align_corners=True).reshape(1, 1, -1, 1, 3)
    base = kpts_fixed.reshape(1, -1, 1, 1, 3)
    f_patch = grid_sample_3d(feat_fixed, base + patch_pt, padding_mode="border",
                             align_corners=True).reshape(C, N, pw, pw, pw)
    f_win = grid_sample_3d(feat_moving, base + win_pt, padding_mode="border",
                           align_corners=True).reshape(C, N, sw, sw, sw)

    corr = F.conv3d(f_win.reshape(1, C * N, sw, sw, sw), f_patch.reshape(C * N, 1, pw, pw, pw),
                    groups=C * N).reshape(C, N, dw, dw, dw)
    patch_sq = torch.sum(f_patch ** 2, dim=(2, 3, 4)).reshape(C, N, 1, 1, 1)
    ones = torch.ones((1, 1, pw, pw, pw), dtype=torch.float32, device=dev)
    win_sq = F.conv3d((f_win ** 2).reshape(C * N, 1, sw, sw, sw), ones).reshape(C, N, dw, dw, dw)
    cost = torch.sum(-2 * corr + patch_sq + win_sq, dim=0)[None]
    return cost / (pw ** 3)


def minconv(cost):
    """Separable min-convolution with a quadratic regularizer over the last
    three axes (w, w, w) of `cost` (reference :227-240)."""
    w = cost.shape[-1]
    disp1d = torch.linspace(-(w // 2), w // 2, w, device=cost.device)
    reg = (disp1d[None, :] - disp1d[:, None]) ** 2
    out = torch.amin(cost.reshape(-1, w, 1, w, w) + reg.reshape(1, w, w, 1, 1), dim=1)
    out = torch.amin(out.reshape(-1, w, w, 1, w) + reg.reshape(1, 1, w, w, 1), dim=2)
    out = torch.amin(out.reshape(-1, w, w, w, 1) + reg.reshape(1, 1, 1, w, w), dim=3)
    out = out - torch.amin(out.reshape(-1, w ** 3), dim=1).reshape(-1, 1, 1, 1)
    return out.reshape(cost.shape)


def sparse_minconv(multi_data_cost, candidates_edges0, candidates_edges1):
    """Min-convolution over candidate displacement sets (reference :244-246)."""
    diff = candidates_edges0[:, None, :, :] - candidates_edges1[:, :, None, :]
    return torch.amin(multi_data_cost[:, None, :] + torch.sum(diff ** 2, dim=3), dim=2)


# ---------------------------------------------------------------------------
# Continuous affine registration (JAX `registration.py:253-334`): the
# first-party stand-in for the reference's BRAINSResample registration step.
# ---------------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps outside the root)


def normalized_affine_grid(mat, trans, out_shape):
    """Grid (1, D, H, W, 3) of normalized (x, y, z) sample coordinates
    (align_corners=False): n_mov = mat @ n_fix + trans, in (x, y, z) == (W,
    H, D) order."""
    D, H, W = out_shape
    dev = mat.device

    def coords(n):
        return (2.0 * torch.arange(n, dtype=torch.float32, device=dev) + 1.0) / n - 1.0

    gz, gy, gx = torch.meshgrid(coords(D), coords(H), coords(W), indexing="ij")
    base = torch.stack([gx, gy, gz], dim=-1)  # (D, H, W, 3) in (x, y, z)
    return (torch.einsum("dhwj,ij->dhwi", base, mat) + trans)[None]


def znorm(v):
    """(v - mean) / (std + 1e-6), the population std, in float32."""
    v = v.float()
    return (v - v.mean()) / (v.std(correction=0) + 1e-6)


def pyramid_level(vol, scale: int):
    """The volume at 1 / scale (linear, align_corners=False), as JAX's
    `resize_nd(vol, max(1, s // scale) ...)`; itself at scale 1."""
    if scale == 1:
        return vol
    return resize_nd(vol, tuple(max(1, s // scale) for s in vol.shape), mode="linear")


def affine_loss(mat, trans, fixed_s, moving_s):
    """Mean squared difference between fixed_s and moving_s pulled back by
    (mat, trans): trilinear, border padding, align_corners=False."""
    grid = normalized_affine_grid(mat, trans, tuple(fixed_s.shape))
    warped = grid_sample_3d(moving_s[None, None], grid, mode="bilinear", padding_mode="border",
                            align_corners=False)[0, 0]
    return torch.mean((warped - fixed_s) ** 2)


def _adam_update(p, g, mu, nu, count: torch.Tensor, lr: float):
    """One optax.adam step, in optax's order of operations: the moments, the
    bias corrections 1 - b^count in float32, mu_hat / (sqrt(nu_hat) + eps),
    then p + (-lr) * update. Returns the new (p, mu, nu)."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu
    b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=p.device)
    b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=p.device)
    mu_hat = mu / (1 - b1 ** count)
    nu_hat = nu / (1 - b2 ** count)
    return p + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), mu, nu


def _voxel_to_normalized(shape) -> np.ndarray:
    """Voxel (i, j, k) -> normalized (x, y, z), homogeneous (4, 4): n =
    2 v / s + 1 / s - 1 per axis, (x, y, z) = (W, H, D)."""
    D, H, W = shape
    n = np.zeros((4, 4), np.float64)
    n[0, 2], n[0, 3] = 2.0 / W, 1.0 / W - 1.0
    n[1, 1], n[1, 3] = 2.0 / H, 1.0 / H - 1.0
    n[2, 0], n[2, 3] = 2.0 / D, 1.0 / D - 1.0
    n[3, 3] = 1.0
    return n


def affine_register(fixed, moving, scales=(4, 2, 1), iters=(120, 80, 40), lr: float = 0.03,
                    device=None) -> np.ndarray:
    """Estimate the affine map from FIXED voxel indices to MOVING voxel
    indices by multi-resolution SSD gradient descent.

    As JAX's `affine_register`: both volumes z-normalized; the map in
    align_corners=False normalized coordinates (the same parameters at every
    pyramid scale), from the identity; at each scale a fresh optax-default
    Adam (lr 0.03) for the given iterations over the mean squared difference
    of the pulled-back moving volume and the fixed one, gradients by
    autograd through the trilinear sampler; then the normalized map
    conjugated into the (i, j, k) == (D, H, W) voxel convention:
    ``v_mov = M @ v_fix``, a (4, 4) float64 array.

    fixed / moving: (D, H, W) arrays or tensors (shapes may differ). Runs on
    `device`, the card unless "cpu" is asked for; within a scale's loop
    nothing waits for the host.
    """
    dev = resolve_device(device)

    def prepared(v):
        return znorm((v if torch.is_tensor(v) else torch.tensor(np.asarray(v))).to(dev))

    fixed_full, moving_full = prepared(fixed), prepared(moving)
    mat = torch.eye(3, dtype=torch.float32, device=dev)
    trans = torch.zeros(3, dtype=torch.float32, device=dev)
    for scale, n_it in zip(scales, iters):
        f_s = pyramid_level(fixed_full, scale)
        m_s = pyramid_level(moving_full, scale)
        state = [torch.zeros_like(mat), torch.zeros_like(mat), torch.zeros_like(trans),
                 torch.zeros_like(trans)]  # mu, nu of mat; mu, nu of trans
        count = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n_it):
            mat_v = mat.detach().requires_grad_(True)
            trans_v = trans.detach().requires_grad_(True)
            g_mat, g_trans = torch.autograd.grad(affine_loss(mat_v, trans_v, f_s, m_s),
                                                 (mat_v, trans_v))
            with torch.no_grad():
                count = count + 1
                mat, state[0], state[1] = _adam_update(mat, g_mat, state[0], state[1], count, lr)
                trans, state[2], state[3] = _adam_update(trans, g_trans, state[2], state[3],
                                                         count, lr)
    A = np.eye(4)
    A[:3, :3] = mat.detach().cpu().numpy().astype(np.float64)
    A[:3, 3] = trans.detach().cpu().numpy().astype(np.float64)
    return (np.linalg.inv(_voxel_to_normalized(tuple(moving_full.shape))) @ A
            @ _voxel_to_normalized(tuple(fixed_full.shape)))
