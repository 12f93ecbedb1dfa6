"""SIFT as OpenCV computes it, written as PyTorch ops, and keypoints as arrays.

Port of ``gims_tpu/frontend/sift.py``. The JAX package detects and
describes with ``cv2.SIFT`` on the host (``detector="host"``,
``sift_descriptor="host"``, its defaults). The port keeps those knobs and
runs OpenCV's algorithm (``sift.dispatch.cpp`` / ``sift.simd.hpp``) on the
frontend's device: the card unless the caller asks for the CPU. Nothing
here imports OpenCV.

On the device: the gray base (the 2x INTER_LINEAR upsample and the blur to
sigma), the Gaussian pyramid, the DoG, the 26-neighbour extrema, the up to
five Newton steps of ``adjustLocalExtrema``, the 36-bin orientation
histograms and ``calcSIFTDescriptor``. On the host, in numpy as in OpenCV
and the JAX package: the gray conversion (``core/imgproc.bgr_to_gray``, the
integer BGR2GRAY), the sort and duplicate removal of
``KeyPointsFilter::removeDuplicatedSorted``, ``filter_top_responses``
(``np.argsort(...)[::-1]``) and the top-up's ``RandomState`` draws.

What OpenCV does that a port easily misses, and what this one does:

- The blurs are OpenCV's separable float filter: a row pass that sums the
  taps as a chain of fused multiply-adds, then a column pass that adds each
  symmetric pair of rows first. A fused multiply-add of float32 values is
  formed here in float64 and rounded once, so the pyramid equals OpenCV's to
  the bit, on the card as on the CPU.
- ``fastAtan2`` is a polynomial about 0.3 degrees off atan2, and the
  exponentials are ``hal::exp32f`` (a 64-entry table and a polynomial):
  both are reproduced with OpenCV's constants and operation order.
- ``compute`` builds its own pyramid, whose first octave is the lowest
  octave among the keypoints it is given: without an octave -1 keypoint
  there is no 2x upsample, and every descriptor changes.
- A keypoint angle of -1 (a top-up point) is described at 361 degrees.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.core.segsum import segment_sum_rows
from gims_tpu_torch.frontend.pyramid import reflect101_index, upsample2x

IMG_BORDER = 5            # SIFT_IMG_BORDER
MAX_INTERP_STEPS = 5      # SIFT_MAX_INTERP_STEPS
ORI_HIST_BINS = 36        # SIFT_ORI_HIST_BINS
ORI_SIG_FCTR = 1.5        # SIFT_ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8      # SIFT_ORI_PEAK_RATIO
INIT_SIGMA = 0.5          # SIFT_INIT_SIGMA
DESCR_WIDTH = 4           # SIFT_DESCR_WIDTH
DESCR_HIST_BINS = 8       # SIFT_DESCR_HIST_BINS
DESCR_SCL_FCTR = 3.0      # SIFT_DESCR_SCL_FCTR
DESCR_MAG_THR = 0.2       # SIFT_DESCR_MAG_THR
INT_DESCR_FCTR = 512.0    # SIFT_INT_DESCR_FCTR
F32 = np.float32
FLT_EPSILON = float(np.finfo(np.float32).eps)
# samples per gathered chunk of windows (orientation and descriptor walks)
CHUNK_SAMPLES = {"cpu": 1 << 20, "cuda": 1 << 23}


@dataclass
class KeypointArrays:
    """Struct-of-arrays view of a keypoint set (numpy, on the host)."""

    pt: np.ndarray        # (N, 2) f32 xy in input-image coordinates
    size: np.ndarray      # (N,) f32
    angle: np.ndarray     # (N,) f32 degrees
    response: np.ndarray  # (N,) f32
    octave: np.ndarray    # (N,) i32 unpacked octave (>= -1)
    layer: np.ndarray     # (N,) i32 layer within octave
    scale: np.ndarray     # (N,) f32 1/2^octave

    def __len__(self):
        return self.pt.shape[0]

    def head(self, n: int) -> "KeypointArrays":
        """The first n keypoints."""
        return self.take(slice(0, n))

    def take(self, idx) -> "KeypointArrays":
        """The keypoints at `idx` (a slice or an index array)."""
        return KeypointArrays(self.pt[idx], self.size[idx], self.angle[idx],
                              self.response[idx], self.octave[idx], self.layer[idx],
                              self.scale[idx])

    @staticmethod
    def concat(a: "KeypointArrays", b: "KeypointArrays") -> "KeypointArrays":
        return KeypointArrays(*(np.concatenate([x, y]) for x, y in zip(
            (a.pt, a.size, a.angle, a.response, a.octave, a.layer, a.scale),
            (b.pt, b.size, b.angle, b.response, b.octave, b.layer, b.scale))))


def unpack_octaves(packed: np.ndarray):
    """Vectorized unpack of OpenCV's kp.octave field
    (reference: utils/library.py:16-35)."""
    packed = packed.astype(np.int64)
    octave = packed & 0xFF
    layer = (packed >> 8) & 0xFF
    octave = np.where(octave >= 128, octave | ~0xFF, octave)
    scale = np.where(
        octave >= 0, 1.0 / (1 << np.maximum(octave, 0)),
        (1 << np.maximum(-octave, 0)).astype(np.float64),
    ).astype(np.float32)
    return octave.astype(np.int32), layer.astype(np.int32), scale


def keypoints_from_packed(pt, size, angle, response, packed) -> KeypointArrays:
    octave, layer, scale = unpack_octaves(np.asarray(packed))
    return KeypointArrays(np.asarray(pt, F32).reshape(-1, 2), np.asarray(size, F32),
                          np.asarray(angle, F32), np.asarray(response, F32),
                          octave, layer, scale)


def topup_keypoints(xy: np.ndarray) -> KeypointArrays:
    """``cv2.KeyPoint(x, y, 1)`` for each row of xy: size 1, angle -1,
    response 0, octave 0, layer 0."""
    n = len(xy)
    return keypoints_from_packed(np.asarray(xy, np.float64).astype(F32), np.ones(n, F32),
                                 np.full(n, -1.0, F32), np.zeros(n, F32),
                                 np.zeros(n, np.int64))


# ---------------------------------------------------------------------------
# float32 arithmetic as OpenCV's compiled code does it
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors (or float32-exact Python floats):
    the product of two float32 values is exact in float64, so one float64
    add and one rounding to float32 give the fused result. With one factor
    in float64 the op computes in float64 and writes float32: two launches."""
    if not torch.is_tensor(a):
        a, b = b, a
    a = a.double()
    if not torch.is_tensor(c):
        return (a * b + c).float()
    shape = torch.broadcast_shapes(a.shape, c.shape, b.shape if torch.is_tensor(b) else ())
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if torch.is_tensor(b):
        return torch.addcmul(c, a, b, out=out)
    return torch.add(c, a, alpha=b, out=out)


_P1 = float(F32(0.9997878412794807) * F32(180 / math.pi))
_P3 = float(F32(-0.3258083974640975) * F32(180 / math.pi))
_P5 = float(F32(0.1555786518463281) * F32(180 / math.pi))
_P7 = float(F32(-0.04432655554792128) * F32(180 / math.pi))
_ATAN_EPS = float(F32(np.finfo(np.float64).eps))


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cv::hal::fastAtan2(y, x, ..., angleInDegrees=true)``, its vector
    code: degrees in [0, 360], a polynomial about 0.3 degrees off atan2."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _ATAN_EPS)
    cc = c * c
    a = _fma(_fma(_fma(cc, _P7, _P5), cc, _P3), cc, _P1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``cv::hal::magnitude32f``: sqrt(fma(x, x, y*y))."""
    return torch.sqrt(_fma(x, x, y * y))


_EXPTAB_SCALE = 6
_EXPPOLY_A0 = 0.9670371139572337719125840413672004409288e-2
_EXP_PRESCALE = float(F32(1.4426950408889634073599246810019 * (1 << _EXPTAB_SCALE)))
_EXP_POSTSCALE = float(F32(1.0 / (1 << _EXPTAB_SCALE)))
_EXP_MAX = float(F32(3000.0 * (1 << _EXPTAB_SCALE) / (1.4426950408889634073599246810019
                                                       * (1 << _EXPTAB_SCALE))))
_EXP_A = [float(F32(v / _EXPPOLY_A0)) for v in (
    .5550339366753125211915322047004666939128e-1,
    .2402265109513301490103372422686535526573,
    .6931471805521448196800669615864773144641,
    1.000000000000002438532970795181890933776)]
_EXP_TAB = (2.0 ** (np.arange(1 << _EXPTAB_SCALE) / (1 << _EXPTAB_SCALE))
            * _EXPPOLY_A0).astype(F32)


def exp32f(x: torch.Tensor) -> torch.Tensor:
    """``cv::hal::exp32f``, its vector code: 2^(i/64) from a table times a
    degree-4 polynomial, in float32."""
    x = torch.clamp(x, -_EXP_MAX, _EXP_MAX) * _EXP_PRESCALE
    xi = torch.round(x)
    xf = (x - xi) * _EXP_POSTSCALE
    xi = xi.to(torch.int32)
    tab = torch.from_numpy(_EXP_TAB).to(x.device)[(xi & 63).long()]
    t = torch.clamp((xi >> _EXPTAB_SCALE) + 127, 0, 255)
    yf = tab * (t << 23).view(torch.float32)
    z = xf + _EXP_A[0]
    z = _fma(z, xf, _EXP_A[1])
    z = _fma(z, xf, _EXP_A[2])
    z = _fma(z, xf, _EXP_A[3])
    return z * yf


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv::getGaussianKernel(cvRound(sigma*8+1)|1, sigma, CV_32F)`` in
    OpenCV's own arithmetic (float64 weights times the reciprocal of their
    sum, then float32), which the blur's bit-equality rests on."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(F32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of one (H, W) float32 image,
    bit for bit: rows as the fused multiply-add chain k0 x0, then + k_i x_i,
    fused but in the last W mod 4 columns; then columns as k_c x_c, then
    + k_i (x_{c+i} + x_{c-i}), fused but in the last W mod 8 columns;
    REFLECT_101."""
    k = gaussian_kernel(sigma)
    n, half = len(k), len(k) // 2
    h, w = x.shape
    dev = x.device
    xp = x[:, torch.from_numpy(reflect101_index(w, half)).to(dev)].double()
    s = torch.empty((h, w), dtype=torch.float32, device=dev)
    torch.mul(xp[:, 0:w], float(k[0]), out=s)
    # OpenCV's vector row code takes 8, then 4 columns at a time with fused
    # multiply-adds; the last W mod 4 columns go through its scalar code,
    # which rounds the product and the sum apart
    w4 = w - w % 4
    rtail = s[:, w4:].clone()
    xt = xp[:, w4:].float()
    for i in range(1, n):
        # computed in float64 (xp), written in float32: one rounding per tap
        torch.add(s, xp[:, i:i + w], alpha=float(k[i]), out=s)
        rtail = rtail + xt[:, i:i + w - w4] * float(k[i])
    if w4 < w:
        s[:, w4:] = rtail
    yp = s.double()[torch.from_numpy(reflect101_index(h, half)).to(dev)]
    s = torch.empty((h, w), dtype=torch.float32, device=dev)
    torch.mul(yp[half:half + h], float(k[half]), out=s)
    # OpenCV's vector column code takes 8 columns at a time with fused
    # multiply-adds; the columns past the last multiple of 8 go through its
    # scalar code, which rounds the product and the sum apart
    w8 = w - w % 8
    tail = s[:, w8:].clone()
    pair = torch.empty((h, w), dtype=torch.float32, device=dev)
    for i in range(1, half + 1):
        # the pair's float64 sum is exact, written rounded to float32 as
        # OpenCV adds it; the tap's weight as a (1,) float64 tensor keeps the
        # multiply-add in float64
        torch.add(yp[half + i:half + i + h], yp[half - i:half - i + h], out=pair)
        kt = torch.full((1,), float(k[half + i]), dtype=torch.float64, device=dev)
        torch.addcmul(s, pair, kt, out=s)
        tail = tail + pair[:, w8:] * float(k[half + i])
    if w8 < w:
        s[:, w8:] = tail
    return s


def _cv_round(v: float) -> int:
    """cvRound of a float or double: round half to even."""
    return int(np.rint(v))


class SIFT:
    """OpenCV's SIFT with nfeatures=0 (keep all), on `device`.

    ``detect`` returns the keypoints of ``cv2.SIFT.detect`` in its order;
    ``compute`` the (N, 128) uint8 descriptors of ``cv2.SIFT.compute`` at
    given keypoints (which it does not change). Images are (H, W, 3) BGR or
    (H, W) gray uint8, on the host."""

    def __init__(self, n_octave_layers: int = 3, contrast_threshold: float = 0.04,
                 edge_threshold: float = 10.0, sigma: float = 1.6, device=None):
        self.n_layers = int(n_octave_layers)
        self.contrast_threshold = float(contrast_threshold)
        self.edge_threshold = float(edge_threshold)
        self.sigma = float(sigma)
        self.device = resolve_device(device)

    # -- the pyramid --------------------------------------------------------

    def _gray(self, image: np.ndarray) -> torch.Tensor:
        from gims_tpu_torch.core.imgproc import bgr_to_gray

        img = np.asarray(image)
        if img.dtype != np.uint8:
            raise ValueError(f"SIFT needs a uint8 image, got {img.dtype}")
        gray = bgr_to_gray(img[..., :3]) if img.ndim == 3 else img
        return torch.from_numpy(np.ascontiguousarray(gray)).to(self.device).float()

    def pyramid(self, gray: torch.Tensor, first_octave: int, n_octaves: int):
        """OpenCV's ``createInitialImage`` and ``buildGaussianPyramid``: a list
        of n_octaves (n_layers + 3, H_o, W_o) float32 tensors."""
        s = F32(self.sigma)
        if first_octave < 0:
            # cv2.resize INTER_LINEAR 2x: taps 1/4, 3/4, exact on integer gray
            base = upsample2x(gray)
            var = s * s - F32(INIT_SIGMA) * F32(INIT_SIGMA) * F32(4)
        else:
            base = gray
            var = s * s - F32(INIT_SIGMA) * F32(INIT_SIGMA)
        sig_diff = float(np.sqrt(max(var, F32(0.01)), dtype=F32))
        k = 2.0 ** (1.0 / self.n_layers)
        sig = [self.sigma]
        for i in range(1, self.n_layers + 3):
            sig_prev = k ** (i - 1) * self.sigma
            sig.append(math.sqrt((sig_prev * k) ** 2 - sig_prev ** 2))
        img = gaussian_blur(base, sig_diff)
        octaves = []
        for _ in range(n_octaves):
            layers = [img]
            for i in range(1, self.n_layers + 3):
                layers.append(gaussian_blur(layers[-1], sig[i]))
            octaves.append(torch.stack(layers))
            src = layers[self.n_layers]
            h2, w2 = src.shape[0] // 2, src.shape[1] // 2
            img = src[:2 * h2:2, :2 * w2:2]
        return octaves

    def detection_octaves(self, h: int, w: int) -> int:
        """cvRound(log2(min side of the doubled base) - 2) + 1."""
        return _cv_round(math.log(min(2 * h, 2 * w)) / math.log(2.0) - 2) + 1

    # -- detection ----------------------------------------------------------

    @torch.no_grad()
    def detect_raw(self, image: np.ndarray):
        """Detection as ``cv2.SIFT.detect``: (KeypointArrays in OpenCV's order,
        the packed octaves (N,) int64 with the sub-layer byte, the detection
        pyramid, first octave -1)."""
        gray = self._gray(image)
        h, w = gray.shape
        with record_function("gims.sift.pyramid"):
            gauss = self.pyramid(gray, -1, self.detection_octaves(h, w))
        cols = self._find_extrema(gauss)
        with record_function("gims.sift.sort"):
            pt, size, angle, resp, packed = _sorted_unique(cols)
        # fold octave -1 back: points and sizes x0.5, the octave byte shifted
        packed = (packed & ~255) | ((packed - 1) & 255)
        kp = keypoints_from_packed(pt * F32(0.5), size * F32(0.5), angle, resp, packed)
        return kp, packed, gauss

    def detect(self, image: np.ndarray) -> KeypointArrays:
        return self.detect_raw(image)[0]

    def _find_extrema(self, gauss):
        """Candidates, relocation and orientations on the device; returns host
        columns x, y, size, angle, response (float32) and packed octave
        (int64), in the detection pyramid's coordinates."""
        with record_function("gims.sift.extrema"):
            cand, dogs = self._candidates(gauss)
        empty = (np.zeros((0, 2), F32),) + tuple(np.zeros(0, F32) for _ in range(3))
        if cand is None:
            return empty + (np.zeros(0, np.int64),)
        dev = self.device
        meta = _octave_meta([d.shape for d in dogs], dev)
        dflat = torch.cat([d.reshape(-1) for d in dogs])
        with record_function("gims.sift.adjust"):
            kp = self._adjust(dflat, meta, cand)
        gmeta = _octave_meta([g.shape for g in gauss], dev)
        gflat = torch.cat([g.reshape(-1) for g in gauss])
        with record_function("gims.sift.orientation"):
            out = self._orientations(gflat, gmeta, kp)
            host = {k: v.cpu().numpy() for k, v in out.items()}
        return (np.stack([host["x"], host["y"]], 1), host["size"], host["angle"],
                host["response"], host["packed"])

    def _candidates(self, gauss):
        """The DoG octaves and every 26-neighbour extremum inside the border,
        as (octave, layer, row, col) rows; None when there is none."""
        L = self.n_layers
        dogs = [g[1:] - g[:-1] for g in gauss]
        thr = math.floor(0.5 * self.contrast_threshold / L * 255)
        cand = []
        for o, d in enumerate(dogs):
            _, hh, ww = d.shape
            if hh <= 2 * IMG_BORDER or ww <= 2 * IMG_BORDER:
                continue
            mx = torch.nn.functional.max_pool3d(d[None, None], 3, stride=1)[0, 0]
            mn = -torch.nn.functional.max_pool3d(-d[None, None], 3, stride=1)[0, 0]
            v = d[1:L + 1, 1:-1, 1:-1]
            ext = ((v > thr) & (v >= mx)) | ((v < -thr) & (v <= mn))
            ext[:, :IMG_BORDER - 1] = False
            ext[:, hh - IMG_BORDER - 1:] = False
            ext[:, :, :IMG_BORDER - 1] = False
            ext[:, :, ww - IMG_BORDER - 1:] = False
            nz = torch.nonzero(ext)
            cand.append(torch.cat([torch.full_like(nz[:, :1], o), nz + 1], 1))
        return (torch.cat(cand) if cand else None), dogs

    def _adjust(self, dflat, meta, cand):
        """``adjustLocalExtrema`` for every candidate at once: up to five
        Newton steps of the 3x3x3 quadratic fit (Cramer's rule in float32),
        the contrast and edge tests. Returns the survivors' fields."""
        L = self.n_layers
        o, layer, r, c = (cand[:, i].clone() for i in range(4))
        off, rows, cols = meta["off"][o], meta["rows"][o], meta["cols"][o]
        plane = rows * cols
        img_scale = float(F32(1.0) / F32(255))
        deriv = float(F32(img_scale) * F32(0.5))
        cross = float(F32(img_scale) * F32(0.25))

        d27 = torch.tensor([(dl, dr, dc) for dl in (-1, 0, 1) for dr in (-1, 0, 1)
                            for dc in (-1, 0, 1)], device=cand.device)

        def derivs():
            # the 3x3x3 neighbourhood of every candidate in one gather
            base = off + layer * plane + r * cols + c
            idx = (base[:, None] + d27[:, 0] * plane[:, None] + d27[:, 1] * cols[:, None]
                   + d27[:, 2])
            cube = dflat[idx]

            def at(dl, dr, dc):
                return cube[:, 9 * (dl + 1) + 3 * (dr + 1) + dc + 1]

            v = at(0, 0, 0)
            dD = ((at(0, 0, 1) - at(0, 0, -1)) * deriv,
                  (at(0, 1, 0) - at(0, -1, 0)) * deriv,
                  (at(1, 0, 0) - at(-1, 0, 0)) * deriv)
            v2 = v * 2
            dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * img_scale
            dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * img_scale
            dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * img_scale
            dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cross
            dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cross
            dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cross
            return v, dD, (dxx, dyy, dss, dxy, dxs, dys)

        n = cand.shape[0]
        status = torch.zeros(n, dtype=torch.int8, device=cand.device)  # 0 run, 1 ok, -1 no
        xi = torch.zeros(n, device=cand.device)
        xr, xc = xi.clone(), xi.clone()
        big = float(F32(2147483647 // 3))
        for _ in range(MAX_INTERP_STEPS):
            _, dD, hess = derivs()
            x0, x1, x2 = _solve3(hess, dD)
            run = status == 0
            xc = torch.where(run, -x0, xc)
            xr = torch.where(run, -x1, xr)
            xi = torch.where(run, -x2, xi)
            conv = run & (xi.abs() < 0.5) & (xr.abs() < 0.5) & (xc.abs() < 0.5)
            status[conv] = 1
            huge = run & ~conv & ((xi.abs() > big) | (xr.abs() > big) | (xc.abs() > big))
            status[huge] = -1
            mv = run & ~conv & ~huge
            c = torch.where(mv, c + torch.round(xc).long(), c)
            r = torch.where(mv, r + torch.round(xr).long(), r)
            layer = torch.where(mv, layer + torch.round(xi).long(), layer)
            out = mv & ((layer < 1) | (layer > L) | (c < IMG_BORDER) | (c >= cols - IMG_BORDER)
                        | (r < IMG_BORDER) | (r >= rows - IMG_BORDER))
            status[out] = -1
            # positions that left the octave are never read again; keep them inside
            layer = layer.clamp(1, L)
            r = torch.minimum(torch.maximum(r, torch.ones_like(r)), rows - 2)
            c = torch.minimum(torch.maximum(c, torch.ones_like(c)), cols - 2)
        keep = torch.nonzero(status == 1)[:, 0]
        o, layer, r, c = o[keep], layer[keep], r[keep], c[keep]
        xi, xr, xc = xi[keep], xr[keep], xc[keep]
        off, rows, cols = off[keep], rows[keep], cols[keep]
        plane = rows * cols
        v, dD, (dxx, dyy, _, dxy, _, _) = derivs()
        # OpenCV's compiled float code contracts a*b + c into fmaf
        t = _fma(dD[2], xi, _fma(dD[1], xr, dD[0] * xc))
        contr = _fma(v, img_scale, t * 0.5)
        ok = contr.abs() * L >= float(F32(self.contrast_threshold))
        tr = dxx + dyy
        det = _fma(dxx, dyy, -(dxy * dxy))
        e = float(F32(self.edge_threshold))
        ok &= (det > 0) & (tr * tr * e < float(F32(e + 1) * F32(e + 1)) * det)
        keep = torch.nonzero(ok)[:, 0]
        o, layer, r, c, xi, xr, xc, contr = (a[keep] for a in (o, layer, r, c, xi, xr, xc,
                                                               contr))
        scale = torch.pow(2.0, o.float())
        sub = torch.round((xi.double() + 0.5) * 255).long()
        pw = torch.pow(2.0, ((layer.float() + xi) / L).double()).float()   # powf
        size = float(F32(self.sigma)) * pw * scale * 2
        return {"o": o, "layer": layer, "r": r, "c": c,
                "x": (c.float() + xc) * scale, "y": (r.float() + xr) * scale,
                "size": size, "response": contr.abs(),
                "packed": o + (layer << 8) + (sub << 16)}

    def _orientations(self, gflat, gmeta, kp):
        """``calcOrientationHist`` at every relocated extremum and its peaks:
        one keypoint per smoothed-histogram peak >= 0.8 of the highest."""
        n = ORI_HIST_BINS
        o, layer, r, c = kp["o"], kp["layer"], kp["r"], kp["c"]
        scl = kp["size"] * 0.5 / torch.pow(2.0, o.float())
        radius = torch.round(scl * float(F32(ORI_SIG_FCTR * 3))).long()
        sig = scl * ORI_SIG_FCTR
        expf_scale = -1.0 / (sig * 2.0 * sig)
        hist = torch.zeros(len(o), n + 4, device=o.device)
        off, rows, cols = gmeta["off"][o], gmeta["rows"][o], gmeta["cols"][o]
        # one chunk on the card: the walk below takes a launch per window pixel
        budget = 1 << 25 if self.device.type == "cuda" else None
        for sel, rad in _chunks(radius, self.device, budget):
            ii, jj = _window(rad, o.device)
            y = r[sel, None] + ii
            x = c[sel, None] + jj
            rr, cc = rows[sel, None], cols[sel, None]
            m = ((ii.abs() <= radius[sel, None]) & (jj.abs() <= radius[sel, None])
                 & (y > 0) & (y < rr - 1) & (x > 0) & (x < cc - 1))
            base = off[sel, None] + layer[sel, None] * (rr * cc)
            y = torch.where(m, y, 1)
            x = torch.where(m, x, 1)
            at = base + y * cc + x
            dx = gflat[at + 1] - gflat[at - 1]
            dy = gflat[at - cc] - gflat[at + cc]
            wgt = exp32f((ii * ii + jj * jj).float() * expf_scale[sel, None])
            ori = fast_atan2(dy, dx)
            mag = magnitude(dx, dy)
            b = torch.round(ori * float(F32(n / 360.0))).long()
            b = torch.where(b >= n, b - n, b)
            b = torch.where(b < 0, b + n, b)
            contrib = torch.where(m, wgt * mag, 0.0)
            # OpenCV's order: one window pixel after the other, row-major; a
            # step adds one value to each histogram, so the sums are the same
            # on every run and every device
            h = hist[sel]
            bt = (b + 2).T.contiguous()[:, :, None]
            ct = contrib.T.contiguous()[:, :, None]
            for k in range(bt.shape[0]):
                h.scatter_add_(1, bt[k], ct[k])
            hist[sel] = h
        hist[:, 0], hist[:, 1] = hist[:, n], hist[:, n + 1]
        hist[:, n + 2], hist[:, n + 3] = hist[:, 2], hist[:, 3]
        t = hist
        sm = _fma(t[:, 0:n] + t[:, 4:n + 4], 1.0 / 16,
                  _fma(t[:, 1:n + 1] + t[:, 3:n + 3], 0.25, t[:, 2:n + 2] * 0.375))
        omax = sm.max(dim=1).values
        mag_thr = omax * float(F32(ORI_PEAK_RATIO))
        left = torch.roll(sm, 1, dims=1)
        right = torch.roll(sm, -1, dims=1)
        peak = (sm > left) & (sm > right) & (sm >= mag_thr[:, None])
        ki, j = torch.nonzero(peak, as_tuple=True)
        hl, hc, hr = left[ki, j], sm[ki, j], right[ki, j]
        bin_ = j.float() + (0.5 * (hl - hr)) / (hl - 2 * hc + hr)
        bin_ = torch.where(bin_ < 0, n + bin_, torch.where(bin_ >= n, bin_ - n, bin_))
        angle = _fma(bin_, -float(F32(360.0) / F32(n)), 360.0)
        angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, 0.0, angle)
        return {"x": kp["x"][ki], "y": kp["y"][ki], "size": kp["size"][ki], "angle": angle,
                "response": kp["response"][ki], "packed": kp["packed"][ki]}

    # -- description --------------------------------------------------------

    @torch.no_grad()
    def compute_device(self, image: np.ndarray, kp: KeypointArrays, gauss=None):
        """(N, 128) uint8 descriptors on the device, as ``cv2.SIFT.compute``.
        `gauss` may pass the detection pyramid (first octave -1); it is used
        only where compute's own pyramid would equal it."""
        n = len(kp)
        if n == 0:
            return torch.zeros((0, 128), dtype=torch.uint8, device=self.device)
        first = min(0, int(kp.octave.min()))
        if first < -1 or int(kp.layer.max()) > self.n_layers + 2:
            raise ValueError("keypoint octave below -1 or layer above n_octave_layers + 2")
        n_oct = int(kp.octave.max()) - first + 1
        if gauss is None or first != -1 or len(gauss) < n_oct:
            with record_function("gims.sift.pyramid"):
                gauss = self.pyramid(self._gray(image), first, n_oct)
        gmeta = _octave_meta([g.shape for g in gauss], self.device)
        gflat = torch.cat([g.reshape(-1) for g in gauss])
        with record_function("gims.sift.describe"):
            return self._describe(gflat, gmeta, kp, first)

    def compute(self, image: np.ndarray, kp: KeypointArrays) -> np.ndarray:
        return self.compute_device(image, kp).cpu().numpy()

    def _describe(self, gflat, gmeta, kp: KeypointArrays, first: int):
        """``calcSIFTDescriptor`` for every keypoint, chunked by radius."""
        dev = self.device
        d, nb = DESCR_WIDTH, DESCR_HIST_BINS
        scale = kp.scale.astype(F32)
        size = kp.size.astype(F32) * scale
        ptf = kp.pt.astype(F32) * scale[:, None]
        ang = F32(360.0) - kp.angle.astype(F32)
        ang = np.where(np.abs(ang - F32(360.0)) < FLT_EPSILON, F32(0), ang).astype(F32)
        scl = size * F32(0.5)
        hist_width = F32(DESCR_SCL_FCTR) * scl
        rad_f = hist_width * F32(1.4142135623730951) * F32(d + 1) * F32(0.5)
        level = (kp.octave.astype(np.int64) - first)
        rows = np.array([s[1] for s in gmeta["shapes"]], np.int64)[level]
        cols = np.array([s[2] for s in gmeta["shapes"]], np.int64)[level]
        cap = np.sqrt(cols.astype(np.float64) ** 2 + rows.astype(np.float64) ** 2).astype(np.int64)
        radius = np.minimum(np.rint(rad_f).astype(np.int64), cap)
        a = (ang * F32(math.pi / 180)).astype(F32).astype(np.float64)
        cos_t = (np.cos(a).astype(F32) / hist_width).astype(F32)
        sin_t = (np.sin(a).astype(F32) / hist_width).astype(F32)

        def T(v, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(v)).to(dev, dtype)

        cy, cx = T(np.rint(ptf[:, 1]).astype(np.int64)), T(np.rint(ptf[:, 0]).astype(np.int64))
        cos_t, sin_t, ori = T(cos_t), T(sin_t), T(ang)
        lvl, rad = T(level), T(radius)
        layer = T(kp.layer.astype(np.int64))
        off, grows, gcols = gmeta["off"][lvl], gmeta["rows"][lvl], gmeta["cols"][lvl]
        hl = (d + 2) * (d + 2) * (nb + 2)
        out = torch.zeros((len(kp), d * d * nb), dtype=torch.uint8, device=dev)
        bins_per_rad = float(F32(nb) / F32(360.0))
        for sel, R in _chunks(rad, dev):
            ii, jj = _window(R, dev)
            ii, jj = ii.float(), jj.float()
            ct, st = cos_t[sel, None], sin_t[sel, None]
            c_rot = jj * ct - ii * st
            r_rot = jj * st + ii * ct
            rbin = r_rot + float(d // 2) - 0.5
            cbin = c_rot + float(d // 2) - 0.5
            y = cy[sel, None] + ii.long()
            x = cx[sel, None] + jj.long()
            rr, cc = grows[sel, None], gcols[sel, None]
            m = ((ii.abs() <= rad[sel, None]) & (jj.abs() <= rad[sel, None])
                 & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
                 & (y > 0) & (y < rr - 1) & (x > 0) & (x < cc - 1))
            y = torch.where(m, y, 1)
            x = torch.where(m, x, 1)
            at = off[sel, None] + layer[sel, None] * (rr * cc) + y * cc + x
            dx = gflat[at + 1] - gflat[at - 1]
            dy = gflat[at - cc] - gflat[at + cc]
            wgt = exp32f((c_rot * c_rot + r_rot * r_rot) * float(F32(-1.0 / (d * d * 0.5))))
            o_ = fast_atan2(dy, dx)
            mag = torch.where(m, magnitude(dx, dy) * wgt, 0.0)
            obin = (o_ - ori[sel, None]) * bins_per_rad
            rbin = torch.where(m, rbin, 0.0)
            cbin = torch.where(m, cbin, 0.0)
            obin = torch.where(m, obin, 0.0)
            r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
            rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
            o0 = o0.long()
            o0 = torch.where(o0 < 0, o0 + nb, o0)
            o0 = torch.where(o0 >= nb, o0 - nb, o0)
            v_r1 = mag * rbin
            v_r0 = mag - v_r1
            v_rc11 = v_r1 * cbin
            v_rc10 = v_r1 - v_rc11
            v_rc01 = v_r0 * cbin
            v_rc00 = v_r0 - v_rc01
            v_rco111 = v_rc11 * obin
            v_rco110 = v_rc11 - v_rco111
            v_rco101 = v_rc10 * obin
            v_rco100 = v_rc10 - v_rco101
            v_rco011 = v_rc01 * obin
            v_rco010 = v_rc01 - v_rco011
            v_rco001 = v_rc00 * obin
            v_rco000 = v_rc00 - v_rco001
            idx = ((r0.long() + 1) * (d + 2) + c0.long() + 1) * (nb + 2) + o0
            steps = (0, 1, nb + 2, nb + 3, (d + 2) * (nb + 2), (d + 2) * (nb + 2) + 1,
                     (d + 3) * (nb + 2), (d + 3) * (nb + 2) + 1)
            vals = torch.stack([v_rco000, v_rco001, v_rco010, v_rco011,
                                v_rco100, v_rco101, v_rco110, v_rco111], -1)
            # one slot before each histogram: an angle of 361 can vote at o0 = -1
            k = len(sel)
            slots = (1 + idx).to(torch.int16)[..., None] + torch.tensor(
                steps, dtype=torch.int16, device=dev)
            # a row per keypoint, in sample order, as OpenCV adds:
            # deterministic on the card too
            hist = segment_sum_rows(vals.reshape(k, -1), slots.reshape(k, -1), hl + 1,
                                    tag="sift_descriptors")
            hist = hist[:, 1:].reshape(k, d + 2, d + 2, nb + 2)
            inner = hist[:, 1:d + 1, 1:d + 1].clone()
            inner[..., 0] += inner[..., nb]
            inner[..., 1] += inner[..., nb + 1]
            raw = inner[..., :nb].reshape(k, d * d * nb)
            nrm2 = (raw * raw).sum(1, keepdim=True)
            thr = torch.sqrt(nrm2) * float(F32(DESCR_MAG_THR))
            raw = torch.minimum(raw, thr)
            nrm2 = (raw * raw).sum(1, keepdim=True)
            nrm2 = INT_DESCR_FCTR / torch.clamp(torch.sqrt(nrm2), min=FLT_EPSILON)
            out[sel] = torch.clamp(torch.round(raw * nrm2), 0, 255).to(torch.uint8)
        return out


def _solve3(hess, b):
    """``Matx33f::solve`` of the symmetric Hessian by Cramer's rule in
    float32, each a*b - c*d contracted to one fmaf as OpenCV's build does;
    a zero determinant gives 0."""
    dxx, dyy, dss, dxy, dxs, dys = hess
    a00, a01, a02 = dxx, dxy, dxs
    a10, a11, a12 = dxy, dyy, dys
    a20, a21, a22 = dxs, dys, dss
    b0, b1, b2 = b
    def ms(p, q, r, t):        # p q - r t, contracted
        return _fma(p, q, -(r * t))

    def comb(p, x, q, y, r, z):  # p x - q y + r z, contracted
        return _fma(r, z, _fma(p, x, -(q * y)))

    det = comb(a00, ms(a11, a22, a21, a12), a01, ms(a10, a22, a20, a12),
               a02, ms(a10, a21, a20, a11))
    zero = det == 0
    inv = 1.0 / torch.where(zero, torch.ones_like(det), det)
    x0 = inv * comb(b0, ms(a11, a22, a12, a21), a01, ms(b1, a22, a12, b2),
                    a02, ms(b1, a21, a11, b2))
    x1 = inv * comb(a00, ms(b1, a22, a12, b2), b0, ms(a10, a22, a12, a20),
                    a02, ms(a10, b2, b1, a20))
    x2 = inv * comb(a00, ms(a11, b2, b1, a21), a01, ms(a10, b2, b1, a20),
                    b0, ms(a10, a21, a11, a20))
    return tuple(torch.where(zero, 0.0, v) for v in (x0, x1, x2))


def _octave_meta(shapes, dev):
    """Offsets, rows and columns of each octave's block in a flat buffer of
    (layers, rows, cols) octaves."""
    sizes = [int(np.prod(s)) for s in shapes]
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return {"off": torch.from_numpy(off).to(dev),
            "rows": torch.tensor([s[1] for s in shapes], dtype=torch.int64, device=dev),
            "cols": torch.tensor([s[2] for s in shapes], dtype=torch.int64, device=dev),
            "shapes": list(shapes)}


def _window(radius: int, dev):
    """Row and column offsets of a (2R+1)^2 window, row-major, as (1, S)."""
    ar = torch.arange(-radius, radius + 1, device=dev)
    ii = ar[:, None].expand(-1, len(ar)).reshape(1, -1)
    jj = ar[None, :].expand(len(ar), -1).reshape(1, -1)
    return ii, jj


def _chunks(radius: torch.Tensor, dev, budget=None):
    """Index chunks of keypoints sorted by radius, each with its largest
    radius, holding at most `budget` (default CHUNK_SAMPLES[device type])
    window samples."""
    budget = budget or CHUNK_SAMPLES.get(torch.device(dev).type, 1 << 20)
    rad = radius.cpu().numpy()
    order = np.argsort(rad, kind="stable")
    i = 0
    while i < len(order):
        r = int(rad[order[i]])
        j = i
        while j < len(order):
            r_j = int(rad[order[j]])
            if (j - i + 1) * (2 * r_j + 1) ** 2 > budget and j > i:
                break
            r = r_j
            j += 1
        yield torch.from_numpy(order[i:j]).to(radius.device), r
        i = j


def _sorted_unique(cols):
    """``KeyPointsFilter::removeDuplicatedSorted``: sort by x, y, size (desc),
    angle, response (desc), packed octave (desc); drop a keypoint equal to the
    one kept before it in x, y, size and angle."""
    pt, size, angle, resp, packed = cols
    order = np.lexsort((-packed, -resp, angle, -size, pt[:, 1], pt[:, 0]))
    pt, size, angle, resp, packed = pt[order], size[order], angle[order], resp[order], \
        packed[order]
    if len(pt) > 1:
        keep = np.ones(len(pt), bool)
        same = ((pt[1:, 0] == pt[:-1, 0]) & (pt[1:, 1] == pt[:-1, 1])
                & (size[1:] == size[:-1]) & (angle[1:] == angle[:-1]))
        keep[1:] = ~same
        pt, size, angle, resp, packed = (a[keep] for a in (pt, size, angle, resp, packed))
    return pt, size, angle, resp, packed


def make_sift(cfg, device=None) -> SIFT:
    """The frontend config's SIFT (reference: utils/common.py:838-848)."""
    return SIFT(n_octave_layers=cfg.n_octave_layers, contrast_threshold=cfg.contrast_threshold,
                edge_threshold=cfg.edge_threshold, sigma=cfg.sigma, device=device)


def filter_top_responses(kp: KeypointArrays, max_num: int) -> KeypointArrays:
    """Keep the strongest max_num keypoints by response.

    Order parity with reference filterMaxNumDesc (utils/common.py:710-718):
    argsort ascending then reversed, so ties come out in descending original
    index order."""
    if not (0 < max_num < len(kp)):
        return kp
    idxs = np.argsort(kp.response.astype(np.float64))[::-1]
    return kp.take(idxs[:max_num])


def _topup(image: np.ndarray, kp: KeypointArrays, max_kp: int, rng) -> Optional[KeypointArrays]:
    """The train path's top-up to exactly max_kp keypoints at random
    coordinates (reference: utils/common.py:866-879), or None."""
    if not (0 < max_kp and len(kp) < max_kp):
        return None
    rng = rng or np.random
    need = max_kp - len(kp)
    coords = np.empty((need, 2), np.float64)
    coords[:, 0] = rng.random_sample(need) * image.shape[1]
    coords[:, 1] = rng.random_sample(need) * image.shape[0]
    return topup_keypoints(coords)


def detect(image_bgr: np.ndarray, cfg, max_keypoints: Optional[int] = None,
           train_topup: bool = False, rng: Optional[np.random.RandomState] = None,
           device=None) -> KeypointArrays:
    """Detect SIFT keypoints, keep the strongest, and optionally top up to
    exactly max_keypoints at random coordinates (train path parity,
    reference: utils/common.py:866-879). OpenCV describes the top-ups and
    returns them unchanged; so are they here."""
    sift = make_sift(cfg, device)
    max_kp = cfg.max_keypoints if max_keypoints is None else max_keypoints
    kp = filter_top_responses(sift.detect(image_bgr), max_kp)
    if train_topup:
        extra = _topup(image_bgr, kp, max_kp, rng)
        if extra is not None:
            kp = KeypointArrays.concat(kp, extra)
    return kp


def detect_and_describe_device(image_bgr: np.ndarray, cfg, max_keypoints: Optional[int] = None,
                               train_topup: bool = False,
                               rng: Optional[np.random.RandomState] = None, device=None):
    """``detect_and_describe`` with the descriptors left on the device."""
    sift = make_sift(cfg, device)
    max_kp = cfg.max_keypoints if max_keypoints is None else max_keypoints
    kp, _, gauss = sift.detect_raw(image_bgr)
    kp = filter_top_responses(kp, max_kp)
    if train_topup:
        extra = _topup(image_bgr, kp, max_kp, rng)
        if extra is not None:
            kp = KeypointArrays.concat(kp, extra)
    return kp, sift.compute_device(image_bgr, kp, gauss)


def detect_and_describe(image_bgr: np.ndarray, cfg, max_keypoints: Optional[int] = None,
                        train_topup: bool = False, rng: Optional[np.random.RandomState] = None,
                        device=None):
    """Detect, keep the strongest, top up where asked, and describe all in
    one ``compute`` (whose pyramid starts at the lowest octave among them).
    Returns (KeypointArrays, (N, 128) uint8 raw descriptors), on the host;
    normalize to unit L2 before use (reference: carhynet/models.py:9-21)."""
    kp, desc = detect_and_describe_device(image_bgr, cfg, max_keypoints, train_topup, rng,
                                          device)
    return kp, desc.cpu().numpy()
