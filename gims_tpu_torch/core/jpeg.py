"""Baseline JPEG decoding and encoding as OpenCV's libjpeg-turbo does them.

``decode_jpeg`` reads Huffman-coded sequential frames of 8-bit samples
(SOF0 and SOF1), interleaved or one component per scan, of 1 component
(gray) or 3 (YCbCr), with sampling factors of 1 or 2 on each axis and
restart intervals. It reproduces ``cv2.imread`` bit for bit: the entropy
decoding runs on the host (a table per Huffman table gives each bit
position's symbol, value and length, so the serial walk is a list lookup
per coefficient); the rest are integer tensor ops on the device the caller
names, each a copy of libjpeg-turbo's C:

- the dequantisation and the "islow" inverse DCT (``jidctint.c``: 13-bit
  constants, two passes, its range-limit table);
- the "fancy" upsampling of ``jdsample.c`` (triangular h2v1, h1v2 and
  h2v2, edges replicated) or its box upsampling where a plane is 2 samples
  wide or less;
- the YCbCr -> BGR tables of ``jdcolor.c`` (16-bit fixed point);
- ``IMREAD_GRAYSCALE`` of a colour file is the Y plane, as libjpeg gives
  ``JCS_GRAYSCALE``; ``IMREAD_COLOR`` of a gray file repeats it;
- an EXIF orientation (APP1, tag 0x0112) is applied as ``cv2.imread``
  applies it.

Progressive, lossless, arithmetic-coded, 12-bit, CMYK and Adobe RGB files
raise ``NotImplementedError`` naming ``ROADMAP.md``.

``encode_jpeg`` writes what ``cv2.imencode(".jpg", img)`` writes at its
defaults: JFIF, the standard tables scaled to `quality` (95), 4:2:0 for
colour (one component for gray), the standard Huffman tables, libjpeg's
BGR -> YCbCr tables, its h2v2 downsampling with the alternating 1, 2 bias,
the islow forward DCT (``jfdctint.c``), quantisation by libjpeg-turbo's
reciprocals, and edges replicated to whole blocks, with DC-only dummy
blocks completing the MCUs. It runs on the host in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_UNSUPPORTED = "is not decoded by the port (ROADMAP.md §1, JPEG kinds not decoded)"

# zigzag position -> natural (row-major) position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

STD_LUMINANCE_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64)

# the standard Huffman tables (ITU T.81 K.3): code counts per length, symbols
DC_LUMINANCE = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMINANCE = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMINANCE = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
AC_CHROMINANCE = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])

# jidctint.c / jfdctint.c constants: FIX(x) = round(x * 2^13)
_CONST_BITS = 13
_PASS1_BITS = 2
_F0_298 = 2446
_F0_390 = 3196
_F0_541 = 4433
_F0_765 = 6270
_F0_899 = 7373
_F1_175 = 9633
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_562 = 20995
_F3_072 = 25172


def huffman_codes(bits, vals):
    """{symbol: (code, length)} of a table given as counts per length."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


# --- decoding: the host part ---


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef = None  # (blocks_y, blocks_x, 64) zigzag-ordered, filled by the scans
        self.quant = None


_VALUE_BIAS = 4096  # added to a decoded value so that a packed entry stays positive
_SLOW, _BAD = -1, -2


class _Table:
    """A Huffman table for the walk: `fast[prefix]` of every 16-bit prefix
    packs (value + bias) << 13 | run << 5 | bits, where a symbol and its
    extra bits fit in the prefix; `_SLOW` where they do not, `_BAD` where no
    code matches. The run is 255 for an end of block (AC tables)."""

    def __init__(self, bits, vals, ac):
        length = np.zeros(1 << 16, np.int64)
        symbol = np.zeros(1 << 16, np.int64)
        for sym, (code, n) in huffman_codes(bits, vals).items():
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = sym
        self.ac = ac
        self.length = length.tolist()
        self.symbol = symbol.tolist()
        prefix = np.arange(1 << 16, dtype=np.int64)
        size = symbol & 15 if ac else symbol
        extra = (prefix >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
        fast = self._pack(extra, size, symbol >> 4 if ac else 0 * symbol, length + size)
        fast = np.where(length + size > 16, _SLOW, fast)
        self.fast = np.where(length == 0, _BAD, fast).tolist()

    def _pack(self, extra, size, run, bits):
        value = np.where(extra < (1 << np.maximum(size - 1, 0)), extra - (1 << size) + 1, extra)
        value = np.where(size > 0, value, 0)
        if self.ac:
            run = np.where((size == 0) & (run != 15), 255, run)
        return ((value + _VALUE_BIAS) << 13) | (run << 5) | bits

    def slow(self, w):
        """The packed entry of the symbol at the top of the 32-bit window `w`."""
        n = self.length[w >> 16]
        if n == 0:
            raise ValueError("corrupt JPEG data: a Huffman code no table holds")
        sym = self.symbol[w >> 16]
        size = sym & 15 if self.ac else sym
        value = (((w << n) & 0xFFFFFFFF) >> (32 - size)) if size else 0
        if size and value < (1 << (size - 1)):
            value += 1 - (1 << size)
        run = sym >> 4 if self.ac else 0
        if self.ac and size == 0 and run != 15:
            run = 255
        return ((value + _VALUE_BIAS) << 13) | (run << 5) | (n + size)


@functools.lru_cache(maxsize=16)
def _table(bits, vals, ac):
    """The walk's table of a Huffman table; most files carry the standard ones."""
    return _Table(bits, vals, ac)


def _windows(buf):
    """The 32 bits that start at every bit position of `buf`."""
    b = np.frombuffer(buf + b"\0" * 5, np.uint8).astype(np.uint64)
    n = len(buf)
    w40 = ((b[:n] << np.uint64(32)) | (b[1:n + 1] << np.uint64(24)) | (b[2:n + 2] << np.uint64(16))
           | (b[3:n + 3] << np.uint64(8)) | b[4:n + 4])
    pos = np.arange(8 * n, dtype=np.uint64)
    return ((w40[pos >> np.uint64(3)] >> (np.uint64(8) - (pos & np.uint64(7))))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _scan_data(data, pos):
    """The entropy-coded bytes from `pos`, unstuffed, split at the restart
    markers: (bytes, start offsets of each interval, position after)."""
    end = pos
    n = len(data)
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= n:
            end = n
            break
        nxt = data[end + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            end += 1 if nxt == 0xFF else 2
            continue
        break
    raw = data[pos:end]
    parts, starts, offset = [], [], 0
    i = 0
    while True:
        j = i
        while True:  # the next RST marker
            j = raw.find(b"\xff", j)
            if j < 0 or j + 1 >= len(raw) or 0xD0 <= raw[j + 1] <= 0xD7:
                break
            j += 1
        seg = raw[i:] if j < 0 or j + 1 >= len(raw) else raw[i:j]
        seg = seg.replace(b"\xff\x00", b"\xff")
        starts.append(offset)
        parts.append(seg)
        offset += len(seg) + 8  # a byte-aligned gap of zeros after each interval
        parts.append(b"\0" * 8)
        if j < 0 or j + 1 >= len(raw):
            break
        i = j + 2
    return b"".join(parts), starts, end


def _decode_scan(data, pos, comps, scan, tables, restart, frame):
    """Walk one scan's entropy-coded data into its components' coefficients;
    the position after it."""
    buf, starts, end = _scan_data(data, pos)
    win = memoryview(_windows(buf))
    hmax, vmax, width, height = frame

    def table(kind, t):
        if (kind, t) not in tables:
            raise ValueError("JPEG scan uses a Huffman table that was not defined")
        bits, vals = tables[(kind, t)]
        return _table(tuple(bits), tuple(vals), kind == 1)

    plans = [(table(0, td), table(1, ta)) for _, td, ta in scan]
    bases, base = [], 0
    for comp, _, _ in scan:
        bases.append(base)
        base += comp.coef.size
    # the flat zigzag offset of each block of each MCU, in scan order
    if len(scan) == 1:
        comp = scan[0][0]
        bw = -(-(-(-width * comp.h // hmax)) // 8)
        bh = -(-(-(-height * comp.v // vmax)) // 8)
        by, bx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        offsets = (by * comp.coef.shape[1] + bx).reshape(-1, 1) * 64
        slot_ids = np.zeros_like(offsets)
    else:
        mcux = -(-width // (8 * hmax))
        mcuy = -(-height // (8 * vmax))
        per, ids = [], []
        for s, (comp, _, _) in enumerate(scan):
            my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(comp.v),
                                       np.arange(comp.h), indexing="ij")
            idx = ((my * comp.v + v) * comp.coef.shape[1] + mx * comp.h + h) * 64 + bases[s]
            per.append(idx.reshape(mcuy * mcux, -1))
            ids.append(np.full_like(per[-1], s))
        offsets = np.concatenate(per, axis=1)
        slot_ids = np.concatenate(ids, axis=1)
    n_mcu, per_mcu = offsets.shape
    coef = [0] * base
    # a corrupt block's coefficients past its end land on the last, as libjpeg's
    # natural-order table with its 16 extra entries of 63 puts them
    zz = list(range(64)) + [63] * 16
    flat_off = offsets.reshape(-1).tolist()
    flat_slot = slot_ids.reshape(-1).tolist()
    interval = restart if restart else n_mcu
    try:
        for r, first in enumerate(range(0, n_mcu, interval)):
            if r >= len(starts):
                raise ValueError("JPEG data ends before its last restart interval")
            bitpos = starts[r] * 8
            pred = [0] * len(scan)
            for b in range(first * per_mcu, min(first + interval, n_mcu) * per_mcu):
                s = flat_slot[b]
                off = flat_off[b]
                dc, ac = plans[s]
                w = win[bitpos]
                e = dc.fast[w >> 16]
                if e < 0:
                    e = dc.slow(w)
                pred[s] += (e >> 13) - _VALUE_BIAS
                coef[off] = pred[s]
                bitpos += e & 31
                fast = ac.fast
                k = 1
                while k < 64:
                    w = win[bitpos]
                    e = fast[w >> 16]
                    if e < 0:
                        e = ac.slow(w)
                    run = (e >> 5) & 255
                    bitpos += e & 31
                    if run == 255:
                        break
                    k += run
                    coef[off + zz[k]] = (e >> 13) - _VALUE_BIAS
                    k += 1
    except IndexError:
        raise ValueError("JPEG data ends inside a block") from None
    flat = np.asarray(coef, np.int64)
    for s, (comp, _, _) in enumerate(scan):
        comp.coef[...] = flat[bases[s]:bases[s] + comp.coef.size].reshape(comp.coef.shape)
    return end


def _exif_orientation(body):
    """The orientation tag of an APP1 Exif body, or 1."""
    if not body.startswith(b"Exif\0\0") or len(body) < 14:
        return 1
    tiff = body[6:]
    order = "<" if tiff[:2] == b"II" else ">"
    import struct

    try:
        ifd = struct.unpack(order + "I", tiff[4:8])[0]
        count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
        for i in range(count):
            e = ifd + 2 + 12 * i
            tag, kind = struct.unpack(order + "HH", tiff[e:e + 4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
    except struct.error:
        return 1
    return 1


def parse_jpeg(data: bytes):
    """The frame of a baseline JPEG with every scan's coefficients decoded:
    (components, (hmax, vmax, width, height), orientation)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    pos = 2
    quant, tables, comps, frame = {}, {}, [], None
    restart, orientation, adobe = 0, 1, False
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if marker in (0xC0, 0xC1):
            precision = body[0]
            if precision != 8:
                raise NotImplementedError(f"a JPEG of {precision}-bit samples {_UNSUPPORTED}")
            height, width, nc = int.from_bytes(body[1:3], "big"), \
                int.from_bytes(body[3:5], "big"), body[5]
            if nc not in (1, 3):
                raise NotImplementedError(f"a JPEG of {nc} components (CMYK?) {_UNSUPPORTED}")
            if height == 0:
                raise NotImplementedError(f"a JPEG whose height is set by a DNL marker "
                                          f"{_UNSUPPORTED}")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                if c.h not in (1, 2) or c.v not in (1, 2) or hmax % c.h or vmax % c.v:
                    raise NotImplementedError(f"a JPEG of sampling factors "
                                              f"{[(k.h, k.v) for k in comps]} {_UNSUPPORTED}")
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
            frame = (hmax, vmax, width, height)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = {0xC2: "progressive", 0xC3: "lossless"}.get(marker, "arithmetic-coded or "
                                                                        "hierarchical")
            raise NotImplementedError(f"a {kind} JPEG (SOF{marker - 0xC0}) {_UNSUPPORTED}")
        elif marker == 0xCC:
            raise NotImplementedError(f"an arithmetic-coded JPEG {_UNSUPPORTED}")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 2 if pq else 1
                q = np.frombuffer(body[i + 1:i + 1 + 64 * size], ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = q.astype(np.int64)
                quant[tq] = nat
                i += 1 + 64 * size
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = list(body[i + 1:i + 17])
                total = sum(bits)
                vals = list(body[i + 17:i + 17 + total])
                tables[(tc, th)] = (bits, vals)
                i += 17 + total
        elif marker == 0xDD:
            restart = int.from_bytes(body[0:2], "big")
        elif marker == 0xE1:
            orientation = _exif_orientation(body) if orientation == 1 else orientation
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = True
            if body[11] != 1 and len(comps) != 1:
                raise NotImplementedError(f"an Adobe JPEG of transform {body[11]} "
                                          f"{_UNSUPPORTED}")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            scan = []
            for i in range(ns):
                cid, t = body[1 + 2 * i], body[2 + 2 * i]
                comp = next(c for c in comps if c.id == cid)
                scan.append((comp, t >> 4, t & 15))
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if ss != 0 or se != 63 or a != 0:
                raise NotImplementedError(f"a JPEG scan of spectral selection {ss}-{se} "
                                          f"{_UNSUPPORTED}")
            pos = _decode_scan(data, pos + length, comps, scan, tables, restart, frame)
            continue
        pos += length
    if frame is None:
        raise ValueError("JPEG without a frame header")
    if len(comps) == 3 and not adobe and [c.id for c in comps] == [82, 71, 66]:
        raise NotImplementedError(f"an RGB JPEG {_UNSUPPORTED}")
    for c in comps:
        if c.tq not in quant:
            raise ValueError("JPEG component without its quantisation table")
        c.quant = quant[c.tq]
    return comps, frame, orientation


# --- decoding: the device part ---


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c, shift):
    """One pass of jpeg_idct_islow over the last axis of (N, 8, 8) int64."""
    c0, c1, c2, c3, c4, c5, c6, c7 = c.unbind(-1)
    z1 = (c2 + c6) * _F0_541
    tmp2 = z1 + c6 * (-_F1_847)
    tmp3 = z1 + c2 * _F0_765
    tmp0 = (c0 + c4) << _CONST_BITS
    tmp1 = (c0 - c4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0 = t0 * _F0_298
    t1 = t1 * _F2_053
    t2 = t2 * _F3_072
    t3 = t3 * _F1_501
    z1 = z1 * (-_F0_899)
    z2 = z2 * (-_F2_562)
    z3 = z3 * (-_F1_961) + z5
    z4 = z4 * (-_F0_390) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return torch.stack([_descale(o, shift) for o in out], dim=-1)


def idct_islow(coef, quant):
    """libjpeg's islow inverse DCT of dequantised (N, 64) natural-order
    coefficients: (N, 8, 8) uint8 samples."""
    x = (coef * quant).reshape(-1, 8, 8)
    # pass 1 on columns: transpose so that each column is the last axis
    ws = _idct_1d(x.transpose(1, 2), _CONST_BITS - _PASS1_BITS).transpose(1, 2)
    out = _idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3)
    i = out & 1023  # libjpeg's post-IDCT range-limit table, wraparound included
    return torch.where(i < 128, i + 128, torch.where(i < 512, torch.full_like(i, 255),
                       torch.where(i < 896, torch.zeros_like(i), i - 896)))


def _plane(comp, device):
    """(rows, cols) int64 samples of a component's block grid."""
    coef = torch.as_tensor(comp.coef, device=device)
    by, bx = coef.shape[:2]
    nat = torch.zeros_like(coef).reshape(-1, 64)
    nat[:, torch.as_tensor(ZIGZAG, device=device)] = coef.reshape(-1, 64)
    q = torch.as_tensor(comp.quant, device=device)
    px = idct_islow(nat, q).reshape(by, bx, 8, 8)
    return px.permute(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _fancy_h2(x):
    """h2v1_fancy_upsample along the last axis (edges replicated)."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return x, left, right


def _upsample(p, comp, hmax, vmax, width, height):
    """A component plane cropped to its sample size and upsampled to the
    image's, as jdsample.c does."""
    dw = -(-width * comp.h // hmax)
    dh = -(-height * comp.v // vmax)
    p = p[:dh, :dw]
    fh, fv = hmax // comp.h, vmax // comp.v
    if fh == 1 and fv == 1:
        out = p
    elif fh == 2 and fv == 1:
        if dw > 2:
            x, left, right = _fancy_h2(p)
            even = (x * 3 + left + 1) >> 2
            odd = (x * 3 + right + 2) >> 2
            out = torch.stack([even, odd], dim=-1).reshape(dh, 2 * dw)
        else:
            out = p.repeat_interleave(2, dim=1)
    elif fh == 1 and fv == 2:
        above = torch.cat([p[:1], p[:-1]], dim=0)
        below = torch.cat([p[1:], p[-1:]], dim=0)
        top = (p * 3 + above + 1) >> 2
        bottom = (p * 3 + below + 2) >> 2
        out = torch.stack([top, bottom], dim=1).reshape(2 * dh, dw)
    elif dw > 2:  # h2v2 fancy: vertical sums first, then the horizontal taps
        above = torch.cat([p[:1], p[:-1]], dim=0)
        below = torch.cat([p[1:], p[-1:]], dim=0)
        rows = []
        for s in (p * 3 + above, p * 3 + below):
            x, left, right = _fancy_h2(s)
            even = (x * 3 + left + 8) >> 4
            odd = (x * 3 + right + 7) >> 4
            rows.append(torch.stack([even, odd], dim=-1).reshape(dh, 2 * dw))
        out = torch.stack(rows, dim=1).reshape(2 * dh, 2 * dw)
    else:
        out = p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return out[:height, :width]


def _ycc_tables(device):
    x = torch.arange(256, dtype=torch.int64, device=device) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


def _orient(img, orientation):
    """``cv2.imread``'s EXIF orientation transform."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, flags: int = IMREAD_COLOR, device="cpu") -> np.ndarray:
    """``cv2.imdecode`` of a baseline JPEG: (H, W, 3) BGR or (H, W) gray uint8."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise NotImplementedError(f"imread flags {flags}: only IMREAD_COLOR and "
                                  "IMREAD_GRAYSCALE are ported")
    comps, (hmax, vmax, width, height), orientation = parse_jpeg(bytes(data))
    device = torch.device(device)
    y = _upsample(_plane(comps[0], device), comps[0], hmax, vmax, width, height)
    if flags == IMREAD_GRAYSCALE or len(comps) == 1:
        out = y.to(torch.uint8)
        if flags == IMREAD_COLOR:
            out = out[..., None].expand(height, width, 3)
    else:
        cb, cr = (_upsample(_plane(c, device), c, hmax, vmax, width, height) for c in comps[1:])
        cr_r, cb_b, cr_g, cb_g = _ycc_tables(device)
        r = y + cr_r[cr]
        g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
        b = y + cb_b[cb]
        out = torch.stack([b, g, r], dim=-1).clamp(0, 255).to(torch.uint8)
    return _orient(out.cpu().numpy(), orientation)


# --- encoding ---


def quality_tables(quality):
    """jpeg_set_quality: the standard tables scaled, baseline-clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    out = []
    for base in (STD_LUMINANCE_QUANT, STD_CHROMINANCE_QUANT):
        q = (base * scale + 50) // 100
        out.append(np.clip(q, 1, 255))
    return out


def _rgb_to_ycc(bgr):
    """jccolor.c's rgb_ycc_convert on (H, W, 3) BGR uint8: int64 Y, Cb, Cr."""
    def fix(v):
        return int(v * 65536 + 0.5)

    one_half, offset = 1 << 15, 128 << 16
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + one_half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + offset + one_half - 1) >> 16
    cr = (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + offset + one_half - 1) >> 16
    return y, cb, cr


def _pad_plane(p, rows, cols):
    """Replicate the last row and column out to (rows, cols)."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _fdct_islow(blocks):
    """jfdctint.c on (N, 8, 8) int64 level-shifted samples (output scaled by 8)."""
    def one_pass(d, first):
        d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
        tmp0, tmp7 = d0 + d7, d0 - d7
        tmp1, tmp6 = d1 + d6, d1 - d6
        tmp2, tmp5 = d2 + d5, d2 - d5
        tmp3, tmp4 = d3 + d4, d3 - d4
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        if first:
            o0 = (tmp10 + tmp11) << _PASS1_BITS
            o4 = (tmp10 - tmp11) << _PASS1_BITS
            shift = _CONST_BITS - _PASS1_BITS
        else:
            o0 = _descale_np(tmp10 + tmp11, _PASS1_BITS)
            o4 = _descale_np(tmp10 - tmp11, _PASS1_BITS)
            shift = _CONST_BITS + _PASS1_BITS
        z1 = (tmp12 + tmp13) * _F0_541
        o2 = _descale_np(z1 + tmp13 * _F0_765, shift)
        o6 = _descale_np(z1 + tmp12 * (-_F1_847), shift)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * _F1_175
        tmp4 = tmp4 * _F0_298
        tmp5 = tmp5 * _F2_053
        tmp6 = tmp6 * _F3_072
        tmp7 = tmp7 * _F1_501
        z1 = z1 * (-_F0_899)
        z2 = z2 * (-_F2_562)
        z3 = z3 * (-_F1_961) + z5
        z4 = z4 * (-_F0_390) + z5
        o7 = _descale_np(tmp4 + z1 + z3, shift)
        o5 = _descale_np(tmp5 + z2 + z4, shift)
        o3 = _descale_np(tmp6 + z2 + z3, shift)
        o1 = _descale_np(tmp7 + z1 + z4, shift)
        return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)

    rows = one_pass(blocks, True)
    return np.swapaxes(one_pass(np.swapaxes(rows, 1, 2), False), 1, 2)


def _descale_np(x, n):
    return (x + (1 << (n - 1))) >> n


def _quantize(dct, q):
    """libjpeg-turbo's quantize() with compute_reciprocal's divisors (the
    divisor of islow is 8 q): round half away from zero, by reciprocals."""
    out = np.empty_like(dct)
    div = q.astype(np.int64) * 8
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, d in enumerate(div.tolist()):
        if d == 1:
            recip[i], corr[i], shift[i] = 1, 0, 0
            continue
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    mag = np.abs(dct)
    val = ((mag + corr) * recip) >> shift
    out = np.where(dct < 0, -val, val)
    return out


def _blocks(plane):
    """(rows, cols) -> (rows/8 * cols/8, 8, 8) in raster order."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _bits_of(values):
    """The bit length of each |value| (the JPEG magnitude category)."""
    mag = np.abs(values)
    n = np.zeros_like(mag)
    while (mag >> n).any():
        n = np.where((mag >> n) > 0, n + 1, n)
    return n


def _huffman_arrays(spec):
    codes = huffman_codes(*spec)
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], size[sym] = c, n
    return code, size


def _entropy_code(coef_zz, table_ids, dc_specs, ac_specs):
    """Huffman-code blocks in scan order: (N, 64) zigzag coefficients with the
    DC already differenced; the bytes, stuffed, padded with ones."""
    n_blocks = len(coef_zz)
    dc_tabs = [_huffman_arrays(s) for s in dc_specs]
    ac_tabs = [_huffman_arrays(s) for s in ac_specs]
    # events: (block, order key, huffman code, its length, extra bits, their count)
    ev_block, ev_key, ev_code, ev_len, ev_extra, ev_nx = [], [], [], [], [], []

    dc = coef_zz[:, 0]
    dn = _bits_of(dc)
    dc_code = np.zeros(n_blocks, np.int64)
    dc_len = np.zeros(n_blocks, np.int64)
    for t, (code, size) in enumerate(dc_tabs):
        m = table_ids == t
        dc_code[m] = code[dn[m]]
        dc_len[m] = size[dn[m]]
    dc_extra = np.where(dc < 0, dc - 1, dc) & ((np.int64(1) << dn) - 1)
    ev_block.append(np.arange(n_blocks))
    ev_key.append(np.zeros(n_blocks, np.int64))
    ev_code.append(dc_code)
    ev_len.append(dc_len)
    ev_extra.append(dc_extra)
    ev_nx.append(dn)

    ac = coef_zz[:, 1:]
    bi, ki = np.nonzero(ac)
    k = ki + 1
    vals = ac[bi, ki]
    prev = np.zeros_like(k)
    same = np.zeros(len(k), bool)
    if len(k):
        same[1:] = bi[1:] == bi[:-1]
        prev[1:] = k[:-1]
    prev = np.where(same, prev, 0)
    run = k - prev - 1
    nzrl = run >> 4
    run = run & 15
    an = _bits_of(vals)
    sym = (run << 4) | an
    tab = table_ids[bi]
    a_code = np.zeros(len(k), np.int64)
    a_len = np.zeros(len(k), np.int64)
    zrl_code = np.zeros(len(k), np.int64)
    zrl_len = np.zeros(len(k), np.int64)
    for t, (code, size) in enumerate(ac_tabs):
        m = tab == t
        a_code[m] = code[sym[m]]
        a_len[m] = size[sym[m]]
        zrl_code[m] = code[0xF0]
        zrl_len[m] = size[0xF0]
    a_extra = np.where(vals < 0, vals - 1, vals) & ((np.int64(1) << an) - 1)
    # the ZRL symbols before a coefficient: key 2 k - 1 sorts them just before it
    zb = np.repeat(bi, nzrl)
    ev_block += [zb, bi]
    ev_key += [np.repeat(2 * k - 1, nzrl), 2 * k]
    ev_code += [np.repeat(zrl_code, nzrl), a_code]
    ev_len += [np.repeat(zrl_len, nzrl), a_len]
    ev_extra += [np.zeros(len(zb), np.int64), a_extra]
    ev_nx += [np.zeros(len(zb), np.int64), an]
    # an end of block where the last coefficient is zero
    last = np.zeros(n_blocks, np.int64)
    if len(k):
        np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    e_code = np.zeros(len(eob), np.int64)
    e_len = np.zeros(len(eob), np.int64)
    for t, (code, size) in enumerate(ac_tabs):
        m = table_ids[eob] == t
        e_code[m] = code[0]
        e_len[m] = size[0]
    ev_block.append(eob)
    ev_key.append(np.full(len(eob), 200, np.int64))
    ev_code.append(e_code)
    ev_len.append(e_len)
    ev_extra.append(np.zeros(len(eob), np.int64))
    ev_nx.append(np.zeros(len(eob), np.int64))

    block = np.concatenate(ev_block)
    key = np.concatenate(ev_key)
    # within one block's ZRLs the order does not matter: they are alike
    order = np.lexsort((key, block))
    word = (np.concatenate(ev_code)[order] << np.concatenate(ev_nx)[order]) \
        | np.concatenate(ev_extra)[order]
    nbits = np.concatenate(ev_len)[order] + np.concatenate(ev_nx)[order]
    total = int(nbits.sum())
    # every bit of every word, most significant first
    owner = np.repeat(np.arange(len(word)), nbits)
    start = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    idx = np.arange(total) - start[owner]
    bits = (word[owner] >> (nbits[owner] - 1 - idx)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    raw = np.packbits(bits)
    # byte stuffing: a zero after every 0xFF
    ff = raw == 0xFF
    out = np.zeros(len(raw) + int(ff.sum()), np.uint8)
    pos = np.arange(len(raw)) + np.concatenate([[0], np.cumsum(ff)[:-1]])
    out[pos] = raw
    return out.tobytes()


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _dht(tc, th, spec):
    bits, vals = spec
    return _segment(0xC4, bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals))


def encode_jpeg(img, quality: int = 95) -> bytes:
    """``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`` of an
    (H, W) gray or (H, W, 3) BGR uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise NotImplementedError(f"JPEG of {img.dtype}: only uint8 is written here")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0 or h > 65535 or w > 65535:
        raise ValueError(f"a JPEG cannot hold an image of {w}x{h}")
    lum_q, chr_q = quality_tables(quality)
    gray = img.ndim == 2
    if gray:
        planes = [img.astype(np.int64)]
        factors = [(1, 1)]
        hmax = vmax = 1
        tq = [0]
    else:
        y, cb, cr = _rgb_to_ycc(img)
        hmax = vmax = 2
        # as jcprepct.c and jcsample.c pad: the colour rows replicated to an
        # even count and each row out to twice the chroma blocks' width, then
        # h2v2_downsample (the bias alternating 1, 2 along a row); the chroma
        # rows are replicated to whole blocks after it
        cw, ch = -(-w // 2), -(-h // 2)
        bw = -(-cw // 8) * 8
        subs = []
        for p in (cb, cr):
            p = _pad_plane(p, 2 * ch, 2 * bw)
            s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            bias = np.tile([1, 2], bw // 2 + 1)[:bw]
            subs.append((s + bias) >> 2)
        planes = [y] + subs
        factors = [(2, 2), (1, 1), (1, 1)]
        tq = [0, 1, 1]
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    quant = [lum_q, chr_q]
    comp_blocks = []
    for i, (p, (fh, fv)) in enumerate(zip(planes, factors)):
        dw, dh = -(-w * fh // hmax), -(-h * fv // vmax)
        bw, bh = -(-dw // 8), -(-dh // 8)
        p = _pad_plane(p, bh * 8, bw * 8)
        coefs = _quantize(_fdct_islow(_blocks(p - 128)).reshape(-1, 64), quant[tq[i]]) \
            .reshape(bh, bw, 64)
        # dummy blocks: zero AC, DC of the block to the left, then of the row above
        full = np.zeros((mcuy * fv, mcux * fh, 64), np.int64)
        full[:bh, :bw] = coefs
        for x in range(bw, mcux * fh):
            full[:bh, x, 0] = full[:bh, x - 1, 0]
        comp_blocks.append(full)
        del bw, bh
    # bottom dummy rows take the DC of the MCU's last block of the row above
    for i, (fh, fv) in enumerate(factors):
        full = comp_blocks[i]
        dh = -(-h * fv // vmax)
        bh = -(-dh // 8)
        for yb in range(bh, mcuy * fv):
            prev = full[yb - 1].reshape(mcux, fh, 64)[:, -1, 0]
            full[yb, :, 0] = np.repeat(prev, fh)
    # scan order: for each MCU, each component's blocks row by row
    seq, tids = [], []
    for i, (fh, fv) in enumerate(factors):
        b = comp_blocks[i].reshape(mcuy, fv, mcux, fh, 64).transpose(0, 2, 1, 3, 4) \
            .reshape(mcuy * mcux, fv * fh, 64)
        seq.append(b)
        tids.append(np.full((mcuy * mcux, fv * fh), min(i, 1)))
    blocks = np.concatenate(seq, axis=1).reshape(-1, 64)
    table_ids = np.concatenate(tids, axis=1).reshape(-1)
    zz = blocks[:, ZIGZAG].copy()
    # DC differences per component, in scan order
    for t in range(len(planes)):
        m = np.concatenate([np.full((mcuy * mcux, f[0] * f[1]), j == t)
                            for j, f in enumerate(factors)], axis=1).reshape(-1)
        dc = zz[m, 0]
        zz[m, 0] = np.diff(np.concatenate([[0], dc]))
    dc_specs = [DC_LUMINANCE] + ([] if gray else [DC_CHROMINANCE])
    ac_specs = [AC_LUMINANCE] + ([] if gray else [AC_CHROMINANCE])
    data = _entropy_code(zz, table_ids, dc_specs, ac_specs)
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for t, q in enumerate(quant[:1 if gray else 2]):
        out.append(_segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8).tolist())))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(planes)])
    for i, (fh, fv) in enumerate(factors):
        sof += bytes([i + 1, (fh << 4) | fv, tq[i]])
    out.append(_segment(0xC0, sof))
    out.append(_dht(0, 0, DC_LUMINANCE))
    out.append(_dht(1, 0, AC_LUMINANCE))
    if not gray:
        out.append(_dht(0, 1, DC_CHROMINANCE))
        out.append(_dht(1, 1, AC_CHROMINANCE))
    sos = bytes([len(planes)])
    for i in range(len(planes)):
        t = min(i, 1)
        sos += bytes([i + 1, (t << 4) | t])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)
