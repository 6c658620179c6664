"""A Zstandard frame decoder (RFC 8878) in Python and numpy.

The orbax checkpoints of the JAX package compress every B+tree node of
their OCDBT key-value store and every zarr chunk with zstd
(train/orbax.py). This module decodes them with no compiled codec:

- frames with raw, RLE and compressed blocks, single-segment or windowed,
  with or without a content size, and skippable frames between them;
- literals raw, RLE or Huffman-coded (1 or 4 streams; a tree described by
  direct 4-bit weights or by FSE-compressed weights; treeless blocks that
  repeat the previous tree);
- sequences in all four modes (predefined, RLE, FSE-compressed, repeat)
  for literal lengths, offsets and match lengths, and the repeat offsets;
- the content checksum (the low 32 bits of XXH64, seed 0) when the frame
  carries one.

A malformed frame raises `ZstdError`, and so does a frame that names a
dictionary. Huffman streams decode without a loop per symbol: every bit
position's symbol and successor come from one table lookup, and the chain
of positions from the stream's start by pointer doubling. Sequences run
one Python step each; the data this reads (float32 weights compressed at
level 1) holds few of them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ZstdError", "decompress", "xxh64"]

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """A zstd frame that this decoder cannot read."""


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the hash a zstd content checksum keeps 32 bits of)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        pos = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= data[pos] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        pos += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Bit streams
# ---------------------------------------------------------------------------


class _Forward:
    """Little-endian bits read from the start (FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.start = pos
        self.bit = 0

    def read(self, n: int) -> int:
        byte = self.start + (self.bit >> 3)
        end = self.start + ((self.bit + n + 7) >> 3)
        if end > len(self.data):
            raise ZstdError("FSE table description runs past its block")
        v = int.from_bytes(self.data[byte:end], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        byte = self.start + (self.bit >> 3)
        end = min(len(self.data), self.start + ((self.bit + n + 7) >> 3))
        v = int.from_bytes(self.data[byte:end], "little") >> (self.bit & 7)
        return v & ((1 << n) - 1)

    def bytes_used(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A zstd backward bit stream: the bytes as one little-endian number,
    read from its highest bit down, after the padding marker (the last
    byte's highest set bit). Reads past the start give zero bits and set
    `overflow` (the reference decoder's BIT_DStream_overflow)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            v = int.from_bytes(self.data[p >> 3:(p + n + 7) >> 3], "little")
            return (v >> (p & 7)) & ((1 << n) - 1)
        kept = n + p  # bits that lie inside the stream
        if kept <= 0:
            return 0
        v = int.from_bytes(self.data[:(kept + 7) >> 3], "little")
        return (v & ((1 << kept) - 1)) << -p

    @property
    def overflow(self) -> bool:
        return self.pos < 0


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------


def _read_fse_distribution(data: bytes, pos: int, max_symbol: int,
                           max_log: int) -> tuple[list, int, int]:
    """An FSE table description (RFC 8878 4.1.1) at `data[pos:]`:
    (normalized counts, accuracy log, bytes used)."""
    bits = _Forward(data, pos)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    previous0 = False
    while True:
        if previous0:  # a zero count repeats in 2-bit fields
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep < 3:
                    break
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description names too many symbols")
        mx = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < mx:
            value = low
            bits.read(nbits - 1)
        else:
            value = bits.read(nbits)
            if value >= threshold:
                value -= mx
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining <= 1:
            break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, bits.bytes_used()


def _fse_table(counts: list, log: int) -> tuple[list, list, list]:
    """The decoding table of a normalized distribution: per state its
    symbol, its number of bits and its base for the next state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = symbol[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbol, nbits, base


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------


class _Huffman:
    """A Huffman decoding table: `max_bits`, and per `max_bits`-bit
    prefix of the stream its symbol and code length."""

    def __init__(self, weights: list):
        if len(weights) > 255:
            raise ZstdError("Huffman tree with more than 255 weights")
        if any(w > 11 for w in weights):
            raise ZstdError("Huffman weight above 11")
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("Huffman tree without a symbol")
        max_bits = total.bit_length()  # the next power of two above total
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not sum to a power of two")
        weights = list(weights) + [rest.bit_length()]
        if max_bits > 11:
            raise ZstdError("Huffman code longer than 11 bits")
        sym = np.zeros(1 << max_bits, np.uint8)
        length = np.zeros(1 << max_bits, np.int64)
        p = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    n = 1 << (w - 1)
                    sym[p:p + n] = s
                    length[p:p + n] = max_bits + 1 - w
                    p += n
        if p != 1 << max_bits:
            raise ZstdError("corrupt Huffman tree")
        self.max_bits = max_bits
        self.sym = sym
        self.length = length

    def decode_stream(self, stream: bytes, n: int) -> np.ndarray:
        """The `n` symbols of one backward stream, which they must fill."""
        if n == 0:
            if len(stream) != 0:
                raise ZstdError("Huffman stream for no literals")
            return np.zeros(0, np.uint8)
        if not stream or stream[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        m = self.max_bits
        skip = 9 - stream[-1].bit_length()  # zeros above the marker, and it
        bits = np.unpackbits(np.frombuffer(stream[::-1], np.uint8))[skip:]
        total = bits.size
        bits = np.concatenate([bits, np.zeros(m, np.uint8)]).astype(np.int64)
        window = np.zeros(total + 1, np.int64)  # the next m bits at each position
        for j in range(m):
            window = (window << 1) | bits[j:j + total + 1]
        sink = total + 1
        succ = np.empty(total + 2, np.int64)
        succ[:sink] = np.minimum(np.arange(sink) + self.length[window], sink)
        succ[sink] = sink
        chain = np.zeros(1, np.int64)
        jump = succ
        while chain.size < n:
            chain = np.concatenate([chain, jump[chain]])
            jump = jump[jump]
        chain = chain[:n]
        if chain[-1] == sink or succ[chain[-1]] != total:
            raise ZstdError("Huffman stream does not end with its literals")
        return self.sym[window[chain]]


def _read_huffman_tree(data: bytes, pos: int) -> tuple[_Huffman, int]:
    """A Huffman tree description at `data[pos]`: (table, bytes used)."""
    if pos >= len(data):
        raise ZstdError("Huffman tree description missing")
    header = data[pos]
    if header >= 128:
        n = header - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        if len(raw) != (n + 1) // 2:
            raise ZstdError("truncated Huffman weights")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), 1 + (n + 1) // 2
    end = pos + 1 + header
    if end > len(data) or header == 0:
        raise ZstdError("truncated Huffman weights")
    counts, log, used = _read_fse_distribution(data, pos + 1, 255, 6)
    symbol, nbits, base = _fse_table(counts, log)
    if used >= header:
        raise ZstdError("Huffman weights without their bit stream")
    bits = _Backward(data[pos + 1 + used:end])
    s1 = bits.read(log)
    s2 = bits.read(log)
    weights: list[int] = []
    while True:
        if len(weights) > 254:
            raise ZstdError("too many Huffman weights")
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.overflow:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.overflow:
            weights.append(symbol[s1])
            break
    return _Huffman(weights), 1 + header


# ---------------------------------------------------------------------------
# Sequences
# ---------------------------------------------------------------------------

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# (maximum symbol, maximum accuracy log, predefined distribution)
_KINDS = {"ll": (35, 9, _LL_DEFAULT), "of": (31, 8, _OF_DEFAULT),
          "ml": (52, 9, _ML_DEFAULT)}


class _FrameState:
    """What one block hands the next within a frame."""

    def __init__(self):
        self.huffman: _Huffman | None = None
        self.tables: dict = {}
        self.logs: dict = {}
        self.reps = [1, 4, 8]


def _read_literals(data: bytes, pos: int, end: int,
                   st: _FrameState) -> tuple[bytes, int]:
    """The literals section of a compressed block: (literals, position
    after it)."""
    b0 = data[pos]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            head = 3
        if size > BLOCK_MAX:
            raise ZstdError("literals larger than a block")
        pos += head
        if kind == 0:
            if pos + size > end:
                raise ZstdError("truncated raw literals")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    head, nbits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if pos + head > end:
        raise ZstdError("truncated literals header")
    v = int.from_bytes(data[pos:pos + head], "little") >> 4
    size = v & ((1 << nbits) - 1)
    csize = v >> nbits
    streams = 1 if fmt == 0 else 4
    pos += head
    if size > BLOCK_MAX or pos + csize > end:
        raise ZstdError("corrupt compressed literals header")
    body_end = pos + csize
    if kind == 2:
        st.huffman, used = _read_huffman_tree(data[:body_end], pos)
        pos += used
    elif st.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman tree")
    huff = st.huffman
    if streams == 1:
        out = huff.decode_stream(data[pos:body_end], size)
    else:
        if pos + 6 > body_end:
            raise ZstdError("truncated Huffman jump table")
        s1, s2, s3 = (int.from_bytes(data[pos + i:pos + i + 2], "little")
                      for i in (0, 2, 4))
        pos += 6
        s4 = body_end - pos - s1 - s2 - s3
        each = (size + 3) // 4
        last = size - 3 * each
        if s4 < 0 or last < 0:
            raise ZstdError("corrupt Huffman jump table")
        parts = []
        for ssize, n in ((s1, each), (s2, each), (s3, each), (s4, last)):
            parts.append(huff.decode_stream(data[pos:pos + ssize], n))
            pos += ssize
        out = np.concatenate(parts)
    return out.tobytes(), body_end


def _read_table(data: bytes, pos: int, end: int, kind: str, mode: int,
                st: _FrameState) -> int:
    max_symbol, max_log, default = _KINDS[kind]
    if mode == 0:
        st.tables[kind] = _fse_table(*default)
        st.logs[kind] = default[1]
    elif mode == 1:
        if pos >= end or data[pos] > max_symbol:
            raise ZstdError("corrupt RLE sequence table")
        st.tables[kind] = ([data[pos]], [0], [0])  # one state, no bits
        st.logs[kind] = 0
        return pos + 1
    elif mode == 2:
        counts, log, used = _read_fse_distribution(data[:end], pos, max_symbol,
                                                   max_log)
        st.tables[kind] = _fse_table(counts, log)
        st.logs[kind] = log
        return pos + used
    elif kind not in st.tables:
        raise ZstdError("repeat sequence table with no earlier table")
    return pos


def _decode_block(data: bytes, pos: int, end: int, out: bytearray,
                  st: _FrameState) -> None:
    """A compressed block at `data[pos:end]`, appended to `out`."""
    literals, pos = _read_literals(data, pos, end, st)
    if pos >= end:
        raise ZstdError("compressed block without its sequences section")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += literals
        return
    if pos >= end:
        raise ZstdError("truncated sequences section")
    modes = data[pos]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    pos += 1
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _read_table(data, pos, end, kind, (modes >> shift) & 3, st)
    bits = _Backward(data[pos:end])
    ll_sym, ll_nb, ll_base = st.tables["ll"]
    of_sym, of_nb, of_base = st.tables["of"]
    ml_sym, ml_nb, ml_base = st.tables["ml"]
    ll_s = bits.read(st.logs["ll"])
    of_s = bits.read(st.logs["of"])
    ml_s = bits.read(st.logs["ml"])
    reps = st.reps
    lit = 0
    read = bits.read
    for i in range(nseq):
        of_code = of_sym[of_s]
        ml_code = ml_sym[ml_s]
        ll_code = ll_sym[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("sequence code out of range")
        offset = (1 << of_code) + read(of_code)
        match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        litlen = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset > 3:
            offset -= 3
            reps = [offset, reps[0], reps[1]]
        else:
            idx = offset - 1 + (litlen == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 1:
                offset = reps[1]
                reps = [offset, reps[0], reps[2]]
            elif idx == 2:
                offset = reps[2]
                reps = [offset, reps[0], reps[1]]
            else:
                offset = reps[0] - 1
                reps = [offset, reps[0], reps[1]]
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lit + litlen > len(literals):
            raise ZstdError("sequence reads past its literals")
        out += literals[lit:lit + litlen]
        lit += litlen
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ZstdError("match offset outside the decoded data")
        if offset >= match:
            out += out[start:start + match]
        else:  # the match overlaps its own output: repeat the period
            period = out[start:]
            reps_needed, tail = divmod(match, offset)
            out += period * reps_needed + period[:tail]
    if bits.pos != 0:
        raise ZstdError("sequences do not end with their bit stream")
    st.reps = reps
    out += literals[lit:]


def _decode_frame(data: bytes, pos: int) -> tuple[bytes, int]:
    """The frame at `data[pos:]`, its magic already checked: (content,
    position after it)."""
    n = len(data)
    if pos >= n:
        raise ZstdError("truncated frame header")
    desc = data[pos]
    pos += 1
    fcs_flag = desc >> 6
    single = (desc >> 5) & 1
    if desc & 8:
        raise ZstdError("reserved bit set in the frame header")
    checksum = (desc >> 2) & 1
    did_size = (0, 1, 2, 4)[desc & 3]
    window = None
    if not single:
        if pos >= n:
            raise ZstdError("truncated frame header")
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base // 8) * (wd & 7)
    if did_size:
        if int.from_bytes(data[pos:pos + did_size], "little"):
            raise ZstdError("frame needs a dictionary; none is supported")
        pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        if pos + fcs_size > n:
            raise ZstdError("truncated frame header")
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        pos += fcs_size
    if window is None:
        window = content_size
    block_max = min(window, BLOCK_MAX)
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last = head & 1
        btype = (head >> 1) & 3
        size = head >> 3
        if btype == 0:
            if size > block_max or pos + size > n:
                raise ZstdError("corrupt raw block")
            out += data[pos:pos + size]
            pos += size
        elif btype == 1:
            if size > block_max or pos >= n:
                raise ZstdError("corrupt RLE block")
            out += bytes([data[pos]]) * size
            pos += 1
        elif btype == 2:
            if size > block_max or pos + size > n or size == 0:
                raise ZstdError("corrupt compressed block")
            before = len(out)
            _decode_block(data, pos, pos + size, out, st)
            if len(out) - before > block_max:
                raise ZstdError("block decodes larger than the block maximum")
            pos += size
        else:
            raise ZstdError("reserved block type")
        if content_size is not None and len(out) > content_size:
            raise ZstdError("frame decodes past its content size")
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError("frame decodes to another size than its header says")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return bytes(out), pos


def decompress(data) -> bytes:
    """Every frame of `data` (bytes-like) decoded and joined; skippable
    frames are passed over."""
    data = bytes(data)
    out = []
    pos = 0
    if not data:
        raise ZstdError("no zstd frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            if pos + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        content, pos = _decode_frame(data, pos)
        out.append(content)
    return b"".join(out)
