"""Whole-volume inference over a space axis (`deep_staple_torch/parallel/
spatial.py`) on the CPU: the slab map, the halo exchange and the resize
against slicing and resizing the whole tensor (in threads of one process,
and over gloo ranks), and the sharded eval forward against the unsharded
port and against JAX's `make_whole_volume_inference` on its 8-device mesh
(`tests/test_parallel.py:146-157`). Eight gloo ranks
(`torch_port_ranks.py space`) run every forward case once, in
subprocesses, while this process computes the references."""

import math
import threading

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("space_ranks")
    procs = R.start_step_ranks(out, [], timeout=150, mode="space", world=8)
    yield procs, out
    procs.kill()


def _joined(ranks):
    procs, out = ranks
    procs.wait()
    return out


class _ThreadSpace:
    """S ranks of a space group as threads of this process: `all_reduce`
    sums the ranks' tensors in rank order (the interface of
    `parallel.mesh.SpaceGroup`)."""

    def __init__(self, hub, rank, size, backend="gloo"):
        self.hub, self.rank, self.size, self.backend, self.group = hub, rank, size, backend, None

    def all_reduce(self, t):
        slots, barrier = self.hub
        slots[self.rank] = t.clone()
        barrier.wait()
        total = slots[0].clone()
        for other in slots[1:]:
            total += other
        barrier.wait()
        return t.copy_(total)


def _on_threads(S, fn, backend="gloo"):
    """fn(group) on S threads, one a rank -> the ranks' results."""
    hub = ([None] * S, threading.Barrier(S, timeout=60))
    out, errors = [None] * S, []

    def run(r):
        try:
            out[r] = fn(_ThreadSpace(hub, r, S, backend))
        except BaseException as e:  # noqa: BLE001 - reraised below
            errors.append(e)
            hub[1].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("H", [12, 24, 32, 100, 256])
def test_slab_map_tiles_every_grid(H, S):
    """The three grids' slabs tile [0, extent) in rank order, each finer
    slab twice its coarser one (clipped), the coarsest split as evenly as
    possible; where a rank would get no coarsest row the map refuses. Every
    H that JAX's serve takes (H % S == 0) with a coarsest row a rank is
    taken."""
    from deep_staple_torch.parallel.spatial import slab_map

    low = math.ceil(math.ceil(H / 2) / 2)
    if low < S:
        with pytest.raises(ValueError, match="a rank would hold no row"):
            slab_map(H, S)
        return
    levels = slab_map(H, S)
    extents = [H, math.ceil(H / 2), low]
    for ext, b in zip(extents, levels):
        assert len(b) == S + 1 and b[0] == 0 and b[-1] == ext
        assert all(b[r] < b[r + 1] for r in range(S)), b
    sizes = np.diff(levels[2])
    assert sizes.max() - sizes.min() <= 1 and list(sizes) == sorted(sizes, reverse=True)
    for fine, coarse, ext in ((levels[0], levels[1], H), (levels[1], levels[2], extents[1])):
        assert fine == tuple(min(2 * c, ext) for c in coarse)


def test_slab_map_takes_jax_serves_shapes():
    """JAX's serve checks H % S only (`deep_staple_tpu/serve.py:98-101`);
    its own test serves H = 12 at space 2 (`tests/test_serve.py:78-95`),
    whose 3 coarsest rows split 2 + 1."""
    from deep_staple_torch.parallel.spatial import slab_map

    assert slab_map(12, 2) == ((0, 8, 12), (0, 4, 6), (0, 2, 3))
    assert slab_map(32, 8)[2] == tuple(range(9))
    assert slab_map(256, 2) == ((0, 128, 256), (0, 64, 128), (0, 32, 64))


def _whole_rows(x, g0, g1):
    """Rows [g0, g1) of x's axis 2, zero outside."""
    H = x.shape[2]
    pad = torch.zeros(x.shape[:2] + (max(0, -g0) + max(0, g1 - H),) + x.shape[3:], dtype=x.dtype)
    body = x[:, :, max(g0, 0):min(g1, H)]
    below = pad[:, :, :max(0, -g0)]
    above = pad[:, :, max(0, -g0):]
    return torch.cat([below, body, above], dim=2)


@pytest.mark.parametrize("S, H, dtype", [(2, 7, "float32"), (3, 10, "float32"), (4, 9, "bfloat16"),
                                         (3, 3, "float32")])
def test_halo_rows_match_slicing_the_whole(S, H, dtype):
    """`halo_rows` on threads of one process against slicing the
    zero-padded whole tensor: halos below, at and above a slab's height
    (up to all other slabs), the first and last rank, slabs of unequal
    size, bfloat16 carried as float32 over gloo; the buffer holds only the
    rows some rank reads from another."""
    from deep_staple_torch.parallel.spatial import SlabAxis, even_bounds, halo_rows, window_rows

    x = torch.from_numpy(np.random.RandomState(H).randn(2, 3, H, 4, 5).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    bounds = even_bounds(H, S)
    for lo, hi in ((1, 1), (2, 0), (0, 3), (H, H), (2 * H, 1)):
        window_rows.bytes = 0
        got = _on_threads(S, lambda g: halo_rows(
            x[:, :, bounds[g.rank]:bounds[g.rank + 1]], lo, hi, SlabAxis(g, bounds)))
        for r in range(S):
            want = _whole_rows(x, bounds[r] - lo, bounds[r + 1] + hi)
            assert got[r].dtype == x.dtype
            assert torch.equal(got[r], want), (lo, hi, r)
        needed = {g for r in range(S) for g in range(max(bounds[r] - lo, 0), min(bounds[r + 1] + hi, H))
                  if not bounds[r] <= g < bounds[r + 1]}
        plane = 2 * 3 * 4 * 5 * 4  # carried as float32
        assert window_rows.bytes == S * len(needed) * plane  # each rank's copy of the buffer


@pytest.mark.parametrize("n_in, n_out, S", [(16, 8, 3), (8, 32, 3), (11, 6, 2), (6, 22, 3),
                                            (3, 12, 2), (10, 10, 4)])
def test_resize_h_matches_resizing_the_whole(n_in, n_out, S):
    """`resize_h` on threads against `resize_ndhwc` of the whole tensor,
    sliced: equal bit for bit where the extents differ by a power of two
    (F.interpolate on the slab with the global source rows), within float32
    rounding otherwise; D and W resized too."""
    from deep_staple_torch.ops.resample import resize_ndhwc
    from deep_staple_torch.parallel.spatial import SlabAxis, even_bounds, resize_h

    x = torch.from_numpy(np.random.RandomState(n_in).randn(2, 5, n_in, 6, 3).astype(np.float32))
    want = resize_ndhwc(x, (3, n_out, 4))
    bi, bo = even_bounds(n_in, S), even_bounds(n_out, S)
    got = _on_threads(S, lambda g: resize_h(x[:, :, bi[g.rank]:bi[g.rank + 1]], SlabAxis(g, bi),
                                            SlabAxis(g, bo), (3, 4)))
    exact = max(n_in, n_out) % min(n_in, n_out) == 0 and \
        math.log2(max(n_in, n_out) // min(n_in, n_out)).is_integer()
    for r in range(S):
        ref = want[:, :, bo[r]:bo[r + 1]]
        if exact:
            assert torch.equal(got[r], ref), r
        else:
            np.testing.assert_allclose(got[r].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_space_mean_and_gather_slabs():
    """`space_mean` over unequal slabs equals the whole tensor's float64
    mean rounded once; `gather_slabs` reassembles every rank's slab."""
    from deep_staple_torch.parallel.spatial import SlabAxis, gather_slabs, space_mean

    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 7, 4, 5).astype(np.float32))
    bounds = (0, 3, 5, 7)

    def fn(g):
        ax = SlabAxis(g, bounds)
        mine = x[:, :, ax.start:ax.stop]
        return space_mean(mine, ax), gather_slabs(mine.to(torch.int32), ax)

    for mean, full in _on_threads(3, fn):
        assert torch.equal(mean, space_mean(x))
        assert torch.equal(full, x.to(torch.int32))
    want = x.double().mean(dim=(1, 2, 3), keepdim=True).float()
    torch.testing.assert_close(space_mean(x), want, rtol=0, atol=0)


def test_halo_rows_and_resize_h_over_gloo_ranks(ranks):
    """The same functions over three gloo ranks (H = 10 split 4 + 3 + 3)
    against the whole tensor."""
    from deep_staple_torch.ops.resample import resize_ndhwc
    from deep_staple_torch.parallel.spatial import even_bounds

    x = torch.from_numpy(R.space_rows_input())
    out = _joined(ranks)
    got = [np.load(out / f"rows_rank{r}.npz") for r in range(3)]
    b = even_bounds(x.shape[2], 3)
    for lo, hi in R.HALOS:
        for r in range(3):
            want = _whole_rows(x, b[r] - lo, b[r + 1] + hi).numpy()
            np.testing.assert_array_equal(got[r][f"halo_{lo}_{hi}"], want, err_msg=f"{lo} {hi} {r}")
    for n_out in R.RESIZES:
        want = resize_ndhwc(x, (5, n_out, 3)).numpy()
        bo = even_bounds(n_out, 3)
        for r in range(3):
            np.testing.assert_allclose(got[r][f"resize_{n_out}"], want[:, :, bo[r]:bo[r + 1]],
                                       rtol=1e-6, atol=1e-6, err_msg=f"-> {n_out}, rank {r}")


@pytest.mark.parametrize("case", [c for c in R.SPACE_CASES if not c.startswith("bf16")])
def test_sharded_forward_matches_unsharded(ranks, case):
    """Every rank's gathered logits of the sharded eval forward against the
    unsharded port at rtol / atol 1e-5, the argmax equal (and of both
    classes); the halos moved some rows."""
    want, _ = R.run_space_case(case)
    out = _joined(ranks)
    S = R.SPACE_CASES[case][0]
    am = want.argmax(-1)
    assert 0.1 < am.mean() < 0.9, am.mean()
    for r in range(S):
        got = np.load(out / f"{case}_rank{r}.npz")
        np.testing.assert_allclose(got["logits"], want, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["logits"].argmax(-1), am, err_msg=f"rank {r}")
        assert got["halo_bytes"] > 0


def test_bf16_sharded_forward_within_its_rounding(ranks):
    """A bfloat16 model at space 2: logits within 2e-2 of the unsharded
    bfloat16 port, and the argmax differs only where the unsharded top-two
    margin is under 2e-2 (the count is printed)."""
    want, _ = R.run_space_case("bf16-s2")
    out = _joined(ranks)
    margin = np.abs(want[..., 1] - want[..., 0])
    for r in range(2):
        got = np.load(out / f"bf16-s2_rank{r}.npz")["logits"]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2, err_msg=f"rank {r}")
        flips = got.argmax(-1) != want.argmax(-1)
        print(f"bf16 space 2, rank {r}: {int(flips.sum())} argmax flips of {flips.size}, "
              f"{int((margin < 2e-2).sum())} near-ties under 2e-2")
        assert np.all(margin[flips] < 2e-2)


@pytest.mark.parametrize("S", [8, 4, 2])
def test_sharded_argmax_matches_jax_whole_volume_inference(ranks, S):
    """JAX's `make_whole_volume_inference` on `make_mesh(data=1, space=S)`
    of its 8 CPU devices, from the same weights (`models/interop.py::
    state_dict_to_flax`), at (1, 16, 32, 12): the port's sharded argmax is
    JAX's (`tests/test_parallel.py:146-157`)."""
    import jax
    import jax.numpy as jnp

    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.parallel.mesh import make_mesh
    from deep_staple_tpu.parallel.spatial import make_whole_volume_inference
    from deep_staple_torch.models.interop import state_dict_to_flax

    case = {8: "s8", 4: "s4", 2: "s2"}[S]
    _, _, _, shape = R.SPACE_CASES[case]
    variables = jax.tree.map(jnp.asarray, state_dict_to_flax(R.space_model().state_dict()))
    infer = make_whole_volume_inference(JaxLRASPP(num_classes=2, use_checkpointing=False),
                                        make_mesh(data=1, space=S))
    want = np.asarray(infer(variables, R.space_input(shape)[..., 0]))
    out = _joined(ranks)
    for r in range(S):
        got = np.load(out / f"{case}_rank{r}.npz")["logits"].argmax(-1)
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_make_whole_volume_inference_on_threads():
    """The port's `make_whole_volume_inference` (argmax gathered on every
    rank) at space 4 equals the unsharded argmax, and without a group runs
    the model whole."""
    import copy

    from deep_staple_torch.parallel.spatial import make_whole_volume_inference

    model = R.space_model()
    image = R.space_input((1, 16, 32, 12, 1))[..., 0]
    want = make_whole_volume_inference(copy.deepcopy(model), None)(image)
    got = _on_threads(4, lambda g: make_whole_volume_inference(copy.deepcopy(model), g)(image))
    for r in range(4):
        assert torch.equal(got[r], want), r
