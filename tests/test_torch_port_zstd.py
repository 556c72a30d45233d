"""The port's zstd decoder (`deep_staple_torch/train/zstd.py`) against the
`zstandard` package, and its CRC-32C and XXH64 against `google_crc32c` and
zstd's frame checksum, on the CPU.

The inputs are made from a numpy seed: random bytes, repetitive bytes,
float32 weights (what a checkpoint holds), int8 labels and zeros (RLE), at
the sizes 0, 1, 1 KB, 200 KB (several blocks) and 2 MB, through the levels
-5, 1, 3, 9 and 19 with and without the content checksum. Between them the
frames hold raw, RLE and compressed blocks; raw, RLE and Huffman literals
in one and four streams, with new and repeated tables; and sequences with
predefined, RLE, FSE and repeated tables.
"""

import google_crc32c
import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from deep_staple_torch.train import zstd
from deep_staple_torch.train.ocdbt import crc32c

LEVELS = (-5, 1, 3, 9, 19)


def _data(kind: str) -> bytes:
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "empty":
        return b""
    if kind == "one":
        return b"\x07"
    if kind == "random_1k":
        return rng.bytes(1024)
    if kind == "repetitive_200k":
        return (b"deep_staple " * 3 + rng.bytes(7)) * 4500
    if kind == "weights_200k":
        return (rng.randn(50_000) * 0.05).astype(np.float32).tobytes()
    if kind == "labels_200k":
        return (rng.rand(200_000) < 0.1).astype(np.int8).tobytes()
    if kind == "weights_2m":
        return (rng.randn(500_000) * 0.05).astype(np.float32).tobytes()
    if kind == "zeros_200k":
        return bytes(200_000)
    if kind.startswith("skewed_"):  # Huffman literals in one stream (200) and four (600)
        return np.minimum(rng.geometric(0.25, int(kind[7:])), 255).astype(np.uint8).tobytes()
    raise ValueError(kind)


KINDS = ("empty", "one", "random_1k", "repetitive_200k", "weights_200k", "labels_200k",
         "weights_2m", "zeros_200k", "skewed_200", "skewed_600")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_decompress_matches_zstandard(kind, level):
    data = _data(kind)
    for checksum in (False, True):
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
        assert zstd.decompress(frame) == data, (kind, level, checksum)


def test_rle_literals():
    """A compressed block whose literals are one byte repeated (RLE) and
    which has no sequences, written by hand: zstandard emits an RLE block
    for such data instead."""
    block = bytes([(20 << 3) | 1, 0x41, 0])
    frame = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x20, 20])
             + ((len(block) << 3) | (2 << 1) | 1).to_bytes(3, "little") + block)
    assert zstd.decompress(frame) == b"A" * 20


def test_multiple_and_skippable_frames():
    c = zstandard.ZstdCompressor(level=3)
    a, b = _data("weights_200k"), _data("repetitive_200k")
    skippable = (0x184D2A5A).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(c.compress(a) + skippable + c.compress(b)) == a + b


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=6000), st.integers(min_value=-7, max_value=22))
def test_decompress_any_data(data, level):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("size", [0, 1, 3, 31, 32, 33, 100, 4096, 100_003])
def test_crc32c_and_xxh64(size):
    data = np.random.RandomState(size).bytes(size)
    assert crc32c(data) == google_crc32c.value(data)
    frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


def test_damaged_frames_raise():
    data = _data("weights_200k")
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    bad_sum = bytes(frame[:-1]) + bytes([frame[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad_sum)
    for cut in (3, 10, len(frame) // 2, len(frame) - 5):
        with pytest.raises(ValueError):
            zstd.decompress(bytes(frame[:cut]))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + bytes(frame[1:]))
    frame[len(frame) // 2] ^= 0x5A
    with pytest.raises(ValueError):
        zstd.decompress(bytes(frame))


def test_dictionary_and_window_raise():
    samples = [bytes(np.random.RandomState(i).randint(0, 4, 64).astype(np.uint8)) * 3
               for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(ValueError, match=f"dictionary ID {d.dict_id()}"):
        zstd.decompress(frame)
    # A 1 KB window (window descriptor 0) whose frame holds a 4 KB raw block.
    frame = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x00, 0x00])
             + ((4096 << 3) | 1).to_bytes(3, "little") + bytes(4096))
    with pytest.raises(ValueError, match="window"):
        zstd.decompress(frame)
