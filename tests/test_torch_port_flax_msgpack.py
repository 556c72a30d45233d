"""The port's flax msgpack decoder and encoder (`train/flax_msgpack.py`)
against flax's own, on the CPU.

The trees: the JAX package's `DeepStapleState` from `create_state` after one
JAX train step at test size (async BatchNorm, so the int32 `count` leaves
are there), the same without data parameters (`dp_params` None), the state
with flax's `MAX_CHUNK_SIZE` shrunk so that every array above 4 KiB is
chunked (patched in flax for the bytes, and in the port for its encoder),
and a tree of the other leaf kinds flax writes: bfloat16 arrays, numpy
scalars, a complex, None, bool, ints of every width, floats, strings, bytes,
lists and empty dicts. Every decoded leaf is held bitwise equal, with equal
dtype and shape; the encoder's bytes equal flax's.
"""

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
from deep_staple_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from deep_staple_tpu.train.state import create_state as jax_create_state
from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models.interop import state_from_jax, state_to_jax
from deep_staple_torch.train import flax_msgpack as fm
from deep_staple_torch.train.checkpoint import save_jax_checkpoint
from deep_staple_torch.train.driver import make_model
from torch_port_state import CW, N, SPATIAL, batch

torch.set_num_threads(1)

CONFIG = dict(ool_mode="fused", bn_mode="async", use_checkpointing=False)


@pytest.fixture(scope="module")
def states():
    """{name: JAX state}: after one train step, and one without DP."""
    jm = JaxLRASPP(num_classes=2, use_checkpointing=False, dropout_rate=0.0, bn_mode="async")
    state, tx = jax_create_state(jm, (1, *SPATIAL, 1), N, seed=3)
    fixed = np.full(N, 4.5, np.float32)
    step = jax_make_train_step(jm, tx, JaxConfig(**CONFIG), CW, fixed, augment=False)
    stepped, _ = step(state, batch(3), 0.01, jax.random.PRNGKey(0))
    no_dp, _ = jax_create_state(jm, (1, *SPATIAL, 1), N, seed=4, use_data_params=False)
    return {"train_state": stepped, "no_dp": no_dp}


def _mixed():
    return {
        "bf16": jnp.arange(-6, 6, dtype=jnp.bfloat16).reshape(3, 4) / 3,
        "bf16_scalar": jnp.asarray(1.5, jnp.bfloat16),
        "np_scalar": np.float32(3.25), "np_int": np.int64(-7), "np_bool": np.bool_(True),
        "complex": 1.5 - 2.25j, "none": None, "flags": [True, False],
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, 2**63],
        "floats": [0.1, -1e300, float("inf")], "text": ["", "x" * 31, "y" * 32, "z" * 300],
        "raw": b"\x00\x01" * 200, "empty": {}, "nested": {"a": {"b": np.zeros((0, 3), np.int8)}},
        "u8": np.arange(300, dtype=np.uint8), "f16": np.linspace(0, 1, 17, dtype=np.float16),
        "many": {str(i): np.int32(i) for i in range(20)},
    }


def _tree_and_bytes(states, name, monkeypatch):
    if name == "mixed":  # flax packs dicts in their order in place, sorted in a copy
        return _mixed(), fser.msgpack_serialize(_mixed(), in_place=True)
    if name == "chunked":
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 4096)
        monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 4096)
        name = "train_state"
    return fser.to_state_dict(states[name]), fser.to_bytes(states[name])


def _bits(x):
    if isinstance(x, torch.Tensor):
        raw = x.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(x.dtype).replace("torch.", ""), tuple(x.shape), raw
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_same(got, want, path="."):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) or isinstance(got, torch.Tensor):
        assert type(got) is type(want) or isinstance(got, torch.Tensor), (path, type(got))
        assert _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("name", ["train_state", "no_dp", "chunked", "mixed"])
def test_decoder_matches_flax_msgpack_restore(states, name, monkeypatch):
    _, data = _tree_and_bytes(states, name, monkeypatch)
    want = fser.msgpack_restore(data)
    got = fm.msgpack_restore(data)
    _assert_same(got, want)
    if name == "no_dp":
        assert got["dp_params"] is None and got["dp_opt_state"] is None
    if name == "chunked":
        assert fm.CHUNKED_KEY.encode() in data  # the file holds chunked arrays
    if name == "mixed":
        assert got["bf16"].dtype == torch.bfloat16 and got["bf16"].shape == (3, 4)


def _host(tree):
    """JAX arrays -> numpy, dict order kept (jax.tree.map would sort keys)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


@pytest.mark.parametrize("name", ["train_state", "no_dp", "chunked", "mixed"])
def test_encoder_matches_flax_bytes(states, name, monkeypatch):
    tree, data = _tree_and_bytes(states, name, monkeypatch)
    tree = _host(tree)
    assert fm.to_bytes(tree) == data
    if name == "mixed":  # bfloat16 leaves as the port holds them: torch tensors
        decoded = fm.msgpack_restore(data)
        tree.update(bf16=decoded["bf16"], bf16_scalar=decoded["bf16_scalar"])
        assert fm.to_bytes(tree) == data


def test_state_to_jax_writes_flax_bytes_of_the_jax_state(states):
    """state_from_jax (from the decoded file) then state_to_jax gives the
    state dict that encodes to flax's bytes of the JAX state: the port can
    write a checkpoint as the JAX package writes it after a step."""
    data = fser.to_bytes(states["train_state"])
    model, _ = make_model(TrainConfig(**CONFIG), 2)
    pstate = state_from_jax(fm.msgpack_restore(data), model, device="cpu")
    assert fm.to_bytes(state_to_jax(pstate)) == data


def test_port_checkpoint_is_restored_by_jax(states, tmp_path):
    """`save_jax_checkpoint` writes a directory the JAX package restores,
    leaf for leaf."""
    jstate = states["train_state"]
    model, _ = make_model(TrainConfig(**CONFIG), 2)
    pstate = state_from_jax(fser.msgpack_restore(fser.to_bytes(jstate)), model, device="cpu")
    save_jax_checkpoint(tmp_path / "c", pstate, TrainConfig(**CONFIG))
    back = jax_restore_checkpoint(tmp_path / "c", jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (tmp_path / "c" / "config.json").is_file()


@pytest.mark.parametrize("data, match", [
    (fser.msgpack_serialize({"a": np.arange(4)})[:-3], "truncated"),
    (fser.msgpack_serialize({"a": 1}) + b"\x00", "after the msgpack object"),
    (b"\xd4\x05\x00", "ext type 5"),
    (b"\x81\x01\xc0", "not allowed for map key"),
    (b"\xc1", "not valid"),
    (b"\xc7\x0e\x01\x93\x90\xa9complex32\xc4\x00", "complex32"),
])
def test_decoder_refuses_what_flax_does_not_write(data, match):
    with pytest.raises(ValueError, match=match):
        fm.msgpack_restore(data)
