"""A Zstandard frame decoder (RFC 8878) in Python and numpy, and XXH64.

orbax writes the JAX package's `state.orbax` through tensorstore, whose
OCDBT nodes and zarr chunks are zstd frames (`train/ocdbt.py`,
`train/zarr2.py`); the port reads them without the `zstandard` package.

`decompress(data)` decodes every frame in `data` and returns their content
concatenated: raw, RLE and compressed blocks; literals raw, RLE, or
Huffman-coded in one or four streams, with a new table or the previous one
(treeless), the weights FSE-coded or direct; sequences with predefined, RLE,
FSE-coded or repeated tables and the three repeat offsets. A set content
checksum is verified (`xxh64`). Skippable frames are skipped. A frame that
needs a dictionary, a block or a match beyond the frame's window, and any
malformed input raise `ValueError`.

The bulk of a checkpoint is Huffman-coded literals (float weights). Their
decoding is numpy: the code's length and symbol at every bit offset of a
stream by table lookup, then the chain of code starts from offset 0 by
pointer doubling, so that Python iterates about once a thousand symbols.
Sequences (matches) are decoded one at a time in Python.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # the low 4 bits are free
_BLOCK_MAX = 128 * 1024

# RFC 8878 3.1.1.3.2.1: literal-length and match-length codes.
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# RFC 8878 3.1.1.3.2.2: the predefined distributions and their accuracy logs.
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of each table kind.
_LL_MAX, _ML_MAX, _OF_MAX = (35, 9), (52, 9), (31, 8)


def _fail(what: str):
    raise ValueError(f"zstd: {what}")


# ------------------------------------------------------------------ bit readers

class _Forward:
    """Little-endian bits read from the low end (FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int):
        self.value = int.from_bytes(data[pos:pos + 1024], "little")
        self.bits = 0
        self.limit = 8 * min(1024, len(data) - pos)

    def peek(self, n: int) -> int:
        return (self.value >> self.bits) & ((1 << n) - 1)

    def skip(self, n: int):
        self.bits += n
        if self.bits > self.limit:
            _fail("truncated table description")


class _Backward:
    """A zstd bitstream read from its end: `read(n)` takes the n bits below
    the last one read, most significant first; past the start it reads
    zeros, and `overflow` says so."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            _fail("bitstream without its end marker")
        self.data = data
        self.pos = 8 * len(data) - 9 + data[-1].bit_length()

    def read(self, n: int) -> int:
        self.pos -= n
        p = self.pos
        if p >= 0:
            v = int.from_bytes(self.data[p >> 3:(p + n + 7) >> 3], "little")
            return (v >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        v = int.from_bytes(self.data[:(p + n + 7) >> 3], "little")
        return (v & ((1 << (p + n)) - 1)) << -p

    @property
    def overflow(self) -> bool:
        return self.pos < 0


def _read_bits(stream: bytes) -> np.ndarray:
    """The bits of a backward bitstream in reading order, as uint8."""
    if not stream or stream[-1] == 0:
        _fail("bitstream without its end marker")
    bits = np.unpackbits(np.frombuffer(stream[::-1], np.uint8))
    return bits[9 - stream[-1].bit_length():]


# ------------------------------------------------------------------ FSE

def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at data[pos:] -> (normalized counts,
    accuracy log, bytes taken)."""
    r = _Forward(data, pos)
    log = r.peek(4) + 5
    r.skip(4)
    if log > max_log:
        _fail(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    prev_zero = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev_zero:
            while True:
                rep = r.peek(2)
                r.skip(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        low = r.peek(nbits - 1)
        if low < top:
            count = low
            r.skip(nbits - 1)
        else:
            count = r.peek(nbits)
            if count >= threshold:
                count -= top
            r.skip(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        _fail("corrupt FSE table description")
    return counts, log, (r.bits + 7) // 8


def _fse_table(counts, log):
    """The decoding table of normalized counts: (symbol, bits, base) lists
    of 2^log states (RFC 8878 4.1.1)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        _fail("corrupt FSE distribution")
    nxt = [1 if c == -1 else c for c in counts]
    bits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        bits[u] = log - (n.bit_length() - 1)
        base[u] = (n << bits[u]) - size
    return symbol, bits, base, log


def _rle_table(sym):
    return [sym], [0], [0], 0


# ------------------------------------------------------------------ Huffman

def _huffman_weights(data: bytes, pos: int):
    """The Huffman tree description at data[pos:] -> (weights, bytes taken)."""
    head = data[pos]
    if head >= 128:
        n = head - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            _fail("truncated Huffman weights")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], 1 + (n + 1) // 2
    end = pos + 1 + head
    if end > len(data):
        _fail("truncated Huffman weights")
    counts, log, taken = _read_ncount(data[:end], pos + 1, 255, 6)
    symbol, bits, base, _ = _fse_table(counts, log)
    r = _Backward(data[pos + 1 + taken:end])
    # Two interleaved states; the stream's end emits the other state's symbol.
    states = [r.read(log), r.read(log)]
    weights = []
    while len(weights) < 255:
        for a in (0, 1):
            s = states[a]
            weights.append(symbol[s])
            states[a] = base[s] + r.read(bits[s])
            if r.overflow:
                weights.append(symbol[states[1 - a]])
                return weights, 1 + head
    _fail("too many Huffman weights")


def _huffman_table(weights):
    """(symbol, length) lookup tables of 2^max_bits entries, indexed by the
    next max_bits bits of a stream, and max_bits."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("empty Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        _fail("Huffman weights do not complete a tree")
    weights = list(weights) + [rest.bit_length()]
    if max_bits > 11:
        _fail(f"Huffman code length {max_bits} above 11")
    syms, lens = np.zeros(1 << max_bits, np.uint8), np.zeros(1 << max_bits, np.uint8)
    at = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[at:at + n] = s
                lens[at:at + n] = max_bits + 1 - w
                at += n
    return syms, lens, max_bits


def _huffman_stream(stream: bytes, n: int, table) -> np.ndarray:
    """Decode n symbols of one Huffman stream (numpy; see the module)."""
    syms, lens, max_bits = table
    bits = _read_bits(stream)
    N = len(bits)
    if n == 0:
        if N:
            _fail("Huffman stream longer than its symbols")
        return np.zeros(0, np.uint8)
    padded = np.concatenate([bits, np.zeros(max_bits, np.uint8)]).astype(np.uint16)
    window = np.zeros(N, np.uint16)
    for b in range(max_bits):
        window = (window << 1) | padded[b:b + N]
    # The next code start from each bit offset; offset N (the end) is fixed.
    nxt = np.empty(N + 1, np.int64)
    np.minimum(np.arange(N) + lens[window], N, out=nxt[:N])
    nxt[N] = N
    # Jumps of 2^k codes, k chosen for about a thousand coarse steps.
    k = (n >> 10).bit_length()
    jump = nxt
    for _ in range(k):
        jump = jump[jump]
    coarse = [0]
    for _ in range((n >> k) + 1):
        coarse.append(int(jump[coarse[-1]]))
    cur = np.asarray(coarse, np.int64)
    starts = np.empty((len(cur), 1 << k), np.int64)
    for t in range(1 << k):
        starts[:, t] = cur
        cur = nxt[cur]
    starts = starts.reshape(-1)
    if starts[n] != N or starts[n - 1] >= N:
        _fail("Huffman stream does not end with its last symbol")
    return syms[window[starts[:n]]]


# ------------------------------------------------------------------ blocks

class _FrameState:
    def __init__(self, window: int, start: int):
        self.window = window
        self.start = start  # the frame's first byte in the output
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(block: bytes, st: _FrameState):
    """The literals section -> (literals bytes, bytes taken)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            lit = block[head:head + size]
            if len(lit) != size:
                _fail("truncated raw literals")
            return bytes(lit), head + size
        if len(block) <= head:
            _fail("truncated RLE literals")
        return bytes([block[head]]) * size, head + 1
    head, width = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if len(block) < head:
        _fail("truncated literals header")
    h = int.from_bytes(block[:head], "little")
    mask = (1 << width) - 1
    regen, comp = (h >> 4) & mask, (h >> (4 + width)) & mask
    body = block[head:head + comp]
    if len(body) != comp:
        _fail("truncated compressed literals")
    at = 0
    if kind == 2:
        weights, at = _huffman_weights(body, 0)
        st.huffman = _huffman_table(weights)
    elif st.huffman is None:
        _fail("treeless literals without a previous Huffman table")
    if fmt == 0:
        out = _huffman_stream(body[at:], regen, st.huffman)
    else:
        if comp - at < 6:
            _fail("truncated literal jump table")
        s1, s2, s3 = (int.from_bytes(body[at + i:at + i + 2], "little") for i in (0, 2, 4))
        at += 6
        s4 = comp - at - s1 - s2 - s3
        if s4 < 0:
            _fail("literal streams beyond their section")
        seg = (regen + 3) // 4
        parts = []
        for size, n in ((s1, seg), (s2, seg), (s3, seg), (s4, regen - 3 * seg)):
            if n < 0:
                _fail("corrupt literal stream sizes")
            parts.append(_huffman_stream(body[at:at + size], n, st.huffman))
            at += size
        out = np.concatenate(parts)
    return out.tobytes(), head + comp


def _seq_table(block: bytes, pos: int, mode: int, default, limits, st: _FrameState, idx: int):
    """One sequence table of its compression mode -> bytes taken."""
    if mode == 0:
        st.tables[idx] = _fse_table(*default)
        return 0
    if mode == 1:
        if pos >= len(block):
            _fail("truncated RLE sequence table")
        if block[pos] > limits[0]:
            _fail("RLE sequence symbol out of range")
        st.tables[idx] = _rle_table(block[pos])
        return 1
    if mode == 2:
        counts, log, taken = _read_ncount(block, pos, *limits)
        st.tables[idx] = _fse_table(counts, log)
        return taken
    if st.tables[idx] is None:
        _fail("repeated sequence table without a previous one")
    return 0


def _block(block: bytes, out: bytearray, st: _FrameState):
    """Decode one compressed block, appending to `out`."""
    lit, at = _literals(block, st)
    if at >= len(block):
        _fail("truncated sequences section")
    b0 = block[at]
    if b0 < 128:
        nseq, at = b0, at + 1
    elif b0 < 255:
        nseq, at = ((b0 - 128) << 8) + block[at + 1], at + 2
    else:
        nseq, at = block[at + 1] + (block[at + 2] << 8) + 0x7F00, at + 3
    if nseq == 0:
        out += lit
        return len(lit)
    modes = block[at]
    if modes & 3:
        _fail("reserved bits set in sequence modes")
    at += 1
    for idx, shift, default, limits in ((0, 6, _LL_DEFAULT, _LL_MAX), (1, 4, _OF_DEFAULT, _OF_MAX),
                                        (2, 2, _ML_DEFAULT, _ML_MAX)):
        at += _seq_table(block, at, (modes >> shift) & 3, default, limits, st, idx)
    (ll_sym, ll_bits, ll_base, ll_log), (of_sym, of_bits, of_base, of_log), \
        (ml_sym, ml_bits, ml_base, ml_log) = st.tables
    r = _Backward(block[at:])
    ll, of, ml = r.read(ll_log), r.read(of_log), r.read(ml_log)
    rep = st.rep
    start = len(out)
    lp = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of], ml_sym[ml], ll_sym[ll]
        if of_code > 31:
            _fail("offset code out of range")
        offset_value = (1 << of_code) + r.read(of_code)
        match = _ML_BASE[ml_code] + r.read(_ML_BITS[ml_code])
        literal = _LL_BASE[ll_code] + r.read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            rep = [offset, rep[0], rep[1]]
        else:
            k = offset_value + (literal == 0)
            if k == 1:
                offset = rep[0]
            elif k == 2:
                offset = rep[1]
                rep = [rep[1], rep[0], rep[2]]
            elif k == 3:
                offset = rep[2]
                rep = [rep[2], rep[0], rep[1]]
            else:
                offset = rep[0] - 1
                rep = [offset, rep[0], rep[1]]
        if i + 1 < nseq:
            ll = ll_base[ll] + r.read(ll_bits[ll])
            ml = ml_base[ml] + r.read(ml_bits[ml])
            of = of_base[of] + r.read(of_bits[of])
        if lp + literal > len(lit):
            _fail("sequence past its literals")
        out += lit[lp:lp + literal]
        lp += literal
        if offset == 0 or offset > len(out) - st.start:
            _fail(f"match offset {offset} before the start of the frame")
        if offset > st.window:
            raise ValueError(f"zstd: match offset {offset} beyond the frame's window "
                             f"of {st.window} bytes")
        if offset >= match:
            s = len(out) - offset
            out += out[s:s + match]
        else:
            piece = out[-offset:]
            out += (piece * (match // offset + 1))[:match]
    if r.pos != 0:
        _fail("sequence bitstream not consumed exactly")
    out += lit[lp:]
    st.rep = rep
    return len(out) - start


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the zstd frame at data[pos:] (after its magic) into `out`
    -> the position after it."""
    if pos >= len(data):
        _fail("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _fail("reserved bit set in the frame header")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did:
        raise ValueError(f"zstd: the frame needs dictionary ID {did}, which this decoder "
                         "does not have")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        if pos + fcs_size > len(data):
            _fail("truncated frame header")
        content = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    if window is None:
        window = content
    st = _FrameState(window, len(out))
    block_max = min(window, _BLOCK_MAX)
    start = len(out)
    while True:
        if pos + 3 > len(data):
            _fail("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            _fail("reserved block type")
        if kind == 1:
            if pos >= len(data):
                _fail("truncated RLE block")
            made = size
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > len(data):
                _fail("truncated block")
            if kind == 0:
                out += data[pos:pos + size]
                made = size
            else:
                if size > block_max:
                    _fail("compressed block above the block maximum")
                made = _block(data[pos:pos + size], out, st)
            pos += size
        if made > block_max:
            raise ValueError(f"zstd: a block of {made} bytes beyond the frame's window "
                             f"of {window} bytes")
        if last:
            break
    if content is not None and len(out) - start != content:
        _fail(f"frame content of {len(out) - start} bytes, header says {content}")
    if checksum:
        if pos + 4 > len(data):
            _fail("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            _fail("content checksum mismatch")
        pos += 4
    return pos


def decompress(data) -> bytes:
    """The content of every zstd frame in `data`, concatenated; skippable
    frames are skipped."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        _fail("no frame")
    try:
        while pos < len(data):
            pos = _next_frame(data, pos, out)
    except IndexError as e:
        raise ValueError("zstd: truncated or corrupt frame") from e
    return bytes(out)


def _next_frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode or skip the frame at data[pos:] -> the position after it."""
    if pos + 4 > len(data):
        _fail("truncated frame magic")
    magic = int.from_bytes(data[pos:pos + 4], "little")
    pos += 4
    if magic == MAGIC:
        return _frame(data, pos, out)
    if magic & 0xFFFFFFF0 != _SKIPPABLE:
        _fail(f"bad frame magic {magic:#010x}")
    if pos + 4 > len(data):
        _fail("truncated skippable frame")
    pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
    if pos > len(data):
        _fail("truncated skippable frame")
    return pos


# ------------------------------------------------------------------ XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def _merge(acc, v):
    return ((acc ^ _round(0, v)) * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (zstd's content checksum is its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=4 * stripes).tolist()
        v1, v2, v3, v4 = v
        for i in range(0, 4 * stripes, 4):
            v1 = (_rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1) & _M64
            v2 = (_rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1) & _M64
            v3 = (_rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1) & _M64
            v4 = (_rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1) & _M64
        acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for x in (v1, v2, v3, v4):
            acc = _merge(acc, x)
        pos = 32 * stripes
    else:
        acc = (seed + _P5) & _M64
    acc = (acc + n) & _M64
    while pos + 8 <= n:
        acc = (_rotl(acc ^ _round(0, int.from_bytes(data[pos:pos + 8], "little")), 27) * _P1
               + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        acc = (_rotl(acc ^ (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _M64, 23) * _P2
               + _P3) & _M64
        pos += 4
    while pos < n:
        acc = (_rotl(acc ^ (data[pos] * _P5) & _M64, 11) * _P1) & _M64
        pos += 1
    acc ^= acc >> 33
    acc = (acc * _P2) & _M64
    acc ^= acc >> 29
    acc = (acc * _P3) & _M64
    return acc ^ (acc >> 32)
