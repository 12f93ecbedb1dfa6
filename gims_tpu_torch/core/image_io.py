"""PNG reading and writing with the standard library's zlib and numpy, and
uncompressed BMP reading.

The port's counterpart of ``cv2.imread`` / ``cv2.imwrite`` for the files
the evaluation reads and writes: 8-bit, non-interlaced PNG of colour type
0 (gray), 2 (RGB) or 6 (RGBA), every row filter. ``IMREAD_COLOR`` gives
(H, W, 3) BGR uint8 (alpha dropped, gray replicated), ``IMREAD_GRAYSCALE``
(H, W) uint8, converted as libpng converts for OpenCV. ``imread`` also
reads uncompressed BMP of 8 bits (a palette) or 24 bits, as OpenCV's BMP
decoder does (the UBC patch montages): rows bottom-up or top-down, a gray
conversion in OpenCV's 14-bit fixed point. Other files (JPEG, 16-bit,
palette PNG, interlaced, compressed BMP) raise ``NotImplementedError``:
they need OpenCV's decoders (``ROADMAP.md`` §1, JPEG decoding). ``imwrite``
writes PNG, filter 0 (none) at zlib level 1, OpenCV's default compression.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_NEEDS_OPENCV = ("needs OpenCV's image decoders, which the port does not have "
                 "(ROADMAP.md §1, JPEG decoding)")
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587), as OpenCV calls it
# for IMREAD_GRAYSCALE: 15-bit coefficients truncated from 0.299 * 32768 and
# 0.587 * 32768, the blue one the rest of 32768; the sum is truncated too
_GRAY_R = 9797
_GRAY_G = 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _chunks(data):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    """The Paeth predictor of PNG filter 4, elementwise on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(rows, kinds, prior, bpp):
    """Rows filtered by Average (3) or Paeth (4), one run of them.

    A pixel needs its left, upper and upper-left neighbours only, so the
    run decodes by anti-diagonals: step d reconstructs every pixel (r, c)
    with r + c = d, vectorised over the run's rows and the pixel's bytes.
    `rows` is (n, W, bpp) int16 filtered bytes, `prior` the decoded row
    above the run (zeros for the first row)."""
    n, w, _ = rows.shape
    out = np.zeros((n + 1, w + 1, bpp), np.int16)  # a zero row above, column left
    out[0, 1:] = prior
    paeth = (np.asarray(kinds) == 4)
    for d in range(n + w - 1):
        r = np.arange(max(0, d - w + 1), min(n, d + 1))
        c = d - r
        a = out[r + 1, c]       # left
        b = out[r, c + 1]       # up
        cc = out[r, c]          # up-left
        pred = np.where(paeth[r, None], _paeth(a, b, cc), (a + b) >> 1)
        out[r + 1, c + 1] = (rows[r, c] + pred) & 0xFF
    return out[1:, 1:]


def _unfilter(raw, h, w, bpp):
    """Decoded (h, w, bpp) uint8 samples from the inflated scanlines."""
    stride = w * bpp
    lines = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds = lines[:, 0]
    data = lines[:, 1:].reshape(h, w, bpp).astype(np.int16)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    out = np.zeros((h, w, bpp), np.int16)
    prior = np.zeros((w, bpp), np.int16)
    r = 0
    while r < h:
        k = kinds[r]
        if k in (3, 4):  # a run of Average / Paeth rows
            end = r
            while end < h and kinds[end] in (3, 4):
                end += 1
            out[r:end] = _unfilter_wavefront(data[r:end], kinds[r:end], prior, bpp)
            r = end
        else:
            if k == 0:
                row = data[r]
            elif k == 1:  # Sub: a running sum along the row, mod 256
                row = np.cumsum(data[r], axis=0) & 0xFF
            else:  # Up
                row = (data[r] + prior) & 0xFF
            out[r] = row
            r += 1
        prior = out[r - 1]
    return out.astype(np.uint8)


def decode_png(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """`imread` on the bytes of a PNG file."""
    if not data.startswith(_SIGNATURE):
        raise NotImplementedError(f"only PNG is decoded here; this file {_NEEDS_OPENCV}")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG of bit depth {depth}, colour type {colour}, interlace {interlace}: only "
            f"8-bit non-interlaced gray, RGB and RGBA are decoded here; this file "
            f"{_NEEDS_OPENCV}")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[colour])
    if flags == IMREAD_GRAYSCALE:
        if colour == 0:
            return px[..., 0]
        rgb = px[..., :3].astype(np.int32)
        gray = (_GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2]) >> 15
        same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 0] == rgb[..., 2])
        return np.where(same, rgb[..., 0], gray).astype(np.uint8)
    if flags != IMREAD_COLOR:
        raise NotImplementedError(f"imread flags {flags}: only IMREAD_COLOR and "
                                  "IMREAD_GRAYSCALE are ported")
    if colour == 0:
        return np.ascontiguousarray(np.repeat(px, 3, axis=2))
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR, alpha dropped


def _bgr_to_gray_bmp(bgr):
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R: 14-bit weights, rounded."""
    x = bgr.astype(np.int32)
    return ((1868 * x[..., 0] + 9617 * x[..., 1] + 4899 * x[..., 2] + (1 << 13)) >> 14
            ).astype(np.uint8)


def decode_bmp(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """`imread` on the bytes of an uncompressed 8-bit (palette) or 24-bit BMP."""
    if not data.startswith(b"BM"):
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if bpp not in (8, 24) or comp != 0:
        raise NotImplementedError(f"BMP of {bpp} bits, compression {comp}: only "
                                  f"uncompressed 8- and 24-bit are decoded here; this file "
                                  f"{_NEEDS_OPENCV}")
    rows, width = abs(h), w
    stride = (width * bpp // 8 + 3) & ~3
    raw = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if h > 0:
        raw = raw[::-1]  # bottom-up rows
    if bpp == 24:
        bgr = raw[:, :width * 3].reshape(rows, width, 3)
    else:
        n_pal = struct.unpack("<I", data[46:50])[0] if hsize >= 40 else 0
        pal = np.frombuffer(data, np.uint8, 4 * (n_pal or 256), 14 + hsize).reshape(-1, 4)
        pal = np.concatenate([pal, np.zeros((256 - len(pal), 4), np.uint8)])[:, :3]
        idx = raw[:, :width]
        if flags == IMREAD_GRAYSCALE:
            return np.ascontiguousarray(_bgr_to_gray_bmp(pal)[idx])
        bgr = pal[idx]
    if flags == IMREAD_GRAYSCALE:
        return _bgr_to_gray_bmp(bgr)
    if flags != IMREAD_COLOR:
        raise NotImplementedError(f"imread flags {flags}: only IMREAD_COLOR and "
                                  "IMREAD_GRAYSCALE are ported")
    return np.ascontiguousarray(bgr)


def imread(path, flags: int = IMREAD_COLOR):
    """``cv2.imread`` for PNG and uncompressed BMP: None when the file cannot
    be read."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    if data.startswith(b"BM"):
        return decode_bmp(data, flags)
    return decode_png(data, flags)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8
    image; every row filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise NotImplementedError(f"imwrite of {img.dtype}: only uint8 is written here")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        colour, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        colour = 2 if img.shape[2] == 3 else 6
        px = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)  # BGR(A) -> RGB(A)
    else:
        raise ValueError(f"imwrite takes (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = px.shape[:2]
    lines = np.zeros((h, 1 + w * px.shape[2]), np.uint8)
    lines[:, 1:] = px.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 1)) + _chunk(b"IEND", b""))


def imwrite(path, img) -> bool:
    """``cv2.imwrite`` for ``.png`` paths; other formats raise."""
    if Path(path).suffix.lower() != ".png":
        raise NotImplementedError(f"imwrite {Path(path).name}: only PNG is written here; "
                                  "other formats need OpenCV's encoders (ROADMAP.md §1, "
                                  "JPEG decoding and the match drawings)")
    Path(path).write_bytes(encode_png(img))
    return True
