"""The OpenCV drawing calls of the JAX package's match drawings, in numpy.

The port's counterparts of what ``gims_tpu/eval/viz.py`` draws, each on an
(H, W) or (H, W, C) uint8 image in place, clipped to the image:

- ``line``: ``cv2.line`` of thickness 1, ``LINE_8``: OpenCV's clipping
  (``clipLine``) and its Bresenham iterator, drawn left to right.
- ``circle``: ``cv2.circle`` of ``LINE_8``, filled or of thickness 1:
  OpenCV's midpoint circle (``Circle``).
- ``rectangle``: ``cv2.rectangle`` filled (``FILLED``) or of thickness 1.
- ``polylines``: ``cv2.polylines`` of ``LINE_8``; thickness 1 draws lines,
  a larger thickness OpenCV 5's ``ThickLine``: each segment clipped to the
  image grown by the thickness, then a convex
  quadrilateral in 16-bit fixed point (``FillConvexPoly``, its edges by
  ``Line2``) and a filled circle at its end.
- ``get_text_size`` and ``put_text`` for ``FONT_HERSHEY_SIMPLEX`` at
  ``fontScale`` 1, and at 0.7 of thickness 2 and up (the image viewer's
  labels). OpenCV 5 draws this face with its embedded TrueType
  font, not with Hershey strokes: 8-bit coverage bitmaps at integer pen
  positions, no kerning, one weight for thickness 1 and another for 2 and
  up, and the same coverage for ``LINE_8`` and ``LINE_AA``. The bitmaps and
  advances are data (``core/text_glyphs.py``, read from OpenCV's renders by
  ``scripts/extract_text_glyphs.py``); each glyph blends into the image as
  ``(bg * (255 - a) + colour * a + 127) // 255``. Other scales raise
  ``NotImplementedError`` (``ROADMAP.md`` §1).
- ``gray_to_bgr``: ``cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)``.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np

FILLED = -1
LINE_8 = 8
LINE_AA = 16
FONT_HERSHEY_SIMPLEX = 0

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def gray_to_bgr(img):
    img = np.asarray(img)
    return np.ascontiguousarray(np.repeat(img[..., None], 3, axis=2))


def _colour(img, color):
    """The colour as OpenCV's scalarToRawData writes it into `img`'s type:
    rounded and saturated for uint8, converted as it is for floats."""
    c = np.asarray(color, np.float64).reshape(-1)
    n = 1 if img.ndim == 2 else img.shape[2]
    c = np.concatenate([c, np.zeros(max(0, n - len(c)))])[:n]
    if img.dtype.kind == "f":
        return c.astype(img.dtype)
    return np.clip(np.rint(c), 0, 255).astype(np.uint8)


def _line_type(img, line_type):
    """LINE_AA draws as LINE_8 on images that are not uint8 (OpenCV's rule);
    anti-aliased uint8 shapes are not ported."""
    if line_type == LINE_AA and img.dtype != np.uint8:
        return LINE_8
    if line_type != LINE_8:
        raise NotImplementedError(f"line type {line_type} on a {img.dtype} image: only LINE_8 "
                                  "(and LINE_AA where it draws as LINE_8) is ported "
                                  "(ROADMAP.md §1)")
    return line_type


def _paint(img, ys, xs, colour):
    """Set the pixels (ys, xs) that lie in the image."""
    ys = np.asarray(ys, np.int64)
    xs = np.asarray(xs, np.int64)
    h, w = img.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[keep], xs[keep]] = colour if img.ndim == 3 else colour[0]


def _cdiv(a, b):
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width, height, p1, p2):
    """OpenCV's ``clipLine``: the segment clipped to [0, width) x [0, height),
    or None when nothing of it lies inside."""
    if width <= 0 or height <= 0:
        return None
    inside, q1, q2 = _clip_points(width, height, p1, p2)
    return (q1, q2) if inside else None


def _clip_points(width, height, p1, p2):
    """OpenCV's ``clipLine`` with its points as it leaves them: (inside,
    p1, p2), the points moved toward the image even where nothing of the
    segment lies inside (``fill_poly`` reads them so)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return not (c1 | c2), (x1, y1), (x2, y2)


def line_pixels(width, height, p1, p2):
    """(ys, xs) of ``cv2.line(img, p1, p2, c, 1)`` on a width x height image,
    in the order OpenCV's iterator visits them."""
    clipped = clip_line(width, height, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])))
    if clipped is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # Bresenham with err = major - 2 minor: the minor coordinate after k steps
    m = -((major - 2 * minor * k) // (2 * major)) if major else k * 0
    if dy > dx:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def line(img, pt1, pt2, color, thickness=1):
    """``cv2.line`` of thickness 1, ``LINE_8``."""
    if thickness != 1:
        raise NotImplementedError(f"line of thickness {thickness}: only 1 is ported "
                                  "(ROADMAP.md §1)")
    ys, xs = line_pixels(img.shape[1], img.shape[0], pt1, pt2)
    _paint(img, ys, xs, _colour(img, color))
    return img


def circle_pixels(center, radius, fill):
    """(ys, xs) of OpenCV's midpoint circle, unclipped (pixels may repeat)."""
    cx, cy = int(center[0]), int(center[1])
    ys, xs = [], []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for (y, xa, xb) in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                            (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            run = np.arange(xa, xb + 1) if fill else np.array([xa, xb])
            xs.append(run)
            ys.append(np.full(len(run), y))
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.concatenate(ys).astype(np.int64), np.concatenate(xs).astype(np.int64)


def circle(img, center, radius, color, thickness=1):
    """``cv2.circle`` of ``LINE_8``, filled (``thickness < 0``) or of thickness 1."""
    if thickness > 1:
        raise NotImplementedError(f"circle of thickness {thickness}: only filled and 1 are "
                                  "ported (ROADMAP.md §1)")
    ys, xs = circle_pixels(center, int(radius), thickness < 0)
    _paint(img, ys, xs, _colour(img, color))
    return img


def rectangle(img, pt1, pt2, color, thickness=1, line_type=LINE_8):
    """``cv2.rectangle``, filled (``thickness < 0``) or of thickness 1."""
    _line_type(img, line_type)
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    if thickness < 0:
        h, w = img.shape[:2]
        xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
        ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
        if xa <= xb and ya <= yb:
            img[ya:yb + 1, xa:xb + 1] = _colour(img, color) if img.ndim == 3 else \
                _colour(img, color)[0]
        return img
    return polylines(img, [np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])], True,
                     color, thickness)


def _line2(img, p1, p2, colour):
    """OpenCV's ``Line2``: a line between points in 16-bit fixed point."""
    h, w = img.shape[:2]
    clipped = clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _XY_ONE, _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << _XY_SHIFT, ay | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    x1 += half
    y1 += half
    ys = [(y2 + half) >> _XY_SHIFT]
    xs = [(x2 + half) >> _XY_SHIFT]
    k = np.arange(max(count + 1, 0), dtype=np.int64)
    if ax > ay:
        xs.extend((x1 >> _XY_SHIFT) + k)
        ys.extend((y1 + k * y_step) >> _XY_SHIFT)
    else:
        ys.extend((y1 >> _XY_SHIFT) + k)
        xs.extend((x1 + k * x_step) >> _XY_SHIFT)
    _paint(img, ys, xs, colour)


def _fill_convex_poly(img, v, colour, shift):
    """OpenCV's ``FillConvexPoly`` of ``LINE_8`` on points with `shift`
    fractional bits: the outline by ``Line2``, then the scanline fill."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    p0 = (v[-1][0] << (_XY_SHIFT - shift), v[-1][1] << (_XY_SHIFT - shift))
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    imin = int(np.argmin(ys_all))
    for p in v:
        q = (p[0] << (_XY_SHIFT - shift), p[1] << (_XY_SHIFT - shift))
        _line2(img, p0, q, colour)
        p0 = q
    xmin = (min(xs_all) + delta) >> shift
    xmax = (max(xs_all) + delta) >> shift
    ymin = (min(ys_all) + delta) >> shift
    ymax = (max(ys_all) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    edge = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    y = ymin
    delta1 = delta2 = _XY_ONE >> 1
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (_XY_SHIFT - shift)
                        xe = v[idx][0] << (_XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> _XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = colour if img.ndim == 3 \
                    else colour[0]
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, colour, thickness, flags):
    """OpenCV's ``ThickLine`` of ``LINE_8`` between integer points. OpenCV 5
    first clips the segment to the image grown by `thickness` on each side."""
    h, w = img.shape[:2]
    m = thickness
    clipped = clip_line(w + 2 * m, h + 2 * m, (int(p0[0]) + m, int(p0[1]) + m),
                        (int(p1[0]) + m, int(p1[1]) + m))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = clipped
    p0 = ((x0 - m) << _XY_SHIFT, (y0 - m) << _XY_SHIFT)
    p1 = ((x1 - m) << _XY_SHIFT, (y1 - m) << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * _XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, colour, _XY_SHIFT)
    radius = (thick + (_XY_ONE >> 1)) >> _XY_SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            centre = ((p[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, (p[1] + (_XY_ONE >> 1)) >> _XY_SHIFT)
            ys, xs = circle_pixels(centre, radius, True)
            _paint(img, ys, xs, colour)


# OpenCV's SinTable: sin(i degrees), i = 0 .. 450, as its float literals
# (7 decimals)
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def ellipse2poly(center, axes, angle, arc_start, arc_end, delta):
    """OpenCV's ``ellipse2Poly`` on double points: the arc's vertices every
    `delta` degrees (integer angles, its sine table in float32)."""
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    alpha, beta = _SIN_TABLE[450 - a], _SIN_TABLE[a]  # cos, sin
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        ang = min(i, arc_end)
        if ang < 0:
            ang += 360
        x = axes[0] * _SIN_TABLE[450 - ang]
        y = axes[1] * _SIN_TABLE[ang]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def ellipse(img, center, axes, angle, start_angle, end_angle, color, thickness=1,
            line_type=LINE_8):
    """``cv2.ellipse`` filled (``thickness < 0``) over a whole turn, of
    ``LINE_8`` (and ``LINE_AA`` on a float image, where OpenCV draws it as
    ``LINE_8``): OpenCV's ``EllipseEx``, the vertices of ``ellipse2poly`` in
    16-bit fixed point, then ``FillConvexPoly``. Outlines and partial arcs
    raise (``ROADMAP.md`` §1)."""
    _line_type(img, line_type)
    angle, start, end = (int(np.rint(a)) for a in (angle, start_angle, end_angle))
    if thickness >= 0 or end - start < 360:
        raise NotImplementedError("ellipse: only a filled whole turn is ported (ROADMAP.md §1)")
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    aw, ah = abs(int(axes[0])) << _XY_SHIFT, abs(int(axes[1])) << _XY_SHIFT
    delta = (max(aw, ah) + (_XY_ONE >> 1)) >> _XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    for x, y in ellipse2poly((float(cx), float(cy)), (float(aw), float(ah)), angle, start, end,
                             delta):
        px = int(np.rint(x / _XY_ONE)) << _XY_SHIFT
        py = int(np.rint(y / _XY_ONE)) << _XY_SHIFT
        pt = (px + int(np.rint(x - px)), py + int(np.rint(y - py)))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex_poly(img, v, _colour(img, color), _XY_SHIFT)
    return img


def _collect_poly_edges(img, v, edges, colour):
    """OpenCV's ``CollectPolyEdges`` of ``LINE_8`` on integer points (no
    fractional bits, no offset): each edge's outline by ``Line``, and its
    [y0, y1, x, dx] (x in 16-bit fixed point, the edge's endpoints clipped
    to the image where its outline leaves it)."""
    h, w = img.shape[:2]
    half = _XY_ONE >> 1
    pt0 = (v[-1][0] << _XY_SHIFT, v[-1][1])
    for p in v:
        pt1 = (p[0] << _XY_SHIFT, p[1])
        c0, c1 = list(pt0), list(pt1)
        t0 = ((pt0[0] + half) >> _XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + half) >> _XY_SHIFT, pt1[1])
        _paint(img, *line_pixels(w, h, t0, t1), colour)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # the edge from its outline clipped to the image: its x always,
            # its y where the clipped outline is not one row
            _, t0, t1 = _clip_points(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
            c0[0], c1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx])
        pt0 = pt1


def _fill_edge_collection(img, edges, colour):
    """OpenCV's ``FillEdgeCollection`` of ``LINE_8``: the scanline fill of
    an edge list (even-odd spans of the active edges, kept sorted by x with
    its bubble sort)."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min, y_max = min(e[0] for e in edges), max(e[1] for e in edges)
    x_min = min(min(e[2] for e in edges), min(ends))
    x_max = max(max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    total = len(edges)
    i = 0
    active = []  # the active list, in its linked order
    y_max = min(y_max, h)
    y = edges[0][0]
    while y < y_max:
        draw = False
        pos = 0
        prelast = None
        while pos < len(active) or (i < total and edges[i][0] == y):
            last = active[pos] if pos < len(active) else None
            if last is not None and last[1] == y:
                del active[pos]  # the edge ends at y
                continue
            keep = prelast
            if last is not None and (i >= total or edges[i][0] > y or last[2] < edges[i][2]):
                prelast = last
                pos += 1
            elif i < total:
                active.insert(pos, edges[i])  # the edge starts at y
                prelast = edges[i]
                pos += 1
                i += 1
            else:
                break
            if draw:
                if y >= 0:
                    if keep[2] > prelast[2]:
                        x1, x2 = (prelast[2] + _XY_ONE - 1) >> _XY_SHIFT, keep[2] >> _XY_SHIFT
                    else:
                        x1, x2 = (keep[2] + _XY_ONE - 1) >> _XY_SHIFT, prelast[2] >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = colour if img.ndim == 3 \
                            else colour[0]
                keep[2] += keep[3]
                prelast[2] += prelast[3]
            draw = not draw
        # OpenCV's bubble sort of the active list by x
        stop = None
        while active:
            j, exchanged = 0, None
            while j + 1 < len(active) and active[j] is not stop:
                if active[j][2] > active[j + 1][2]:
                    active[j], active[j + 1] = active[j + 1], active[j]
                    exchanged = active[j]
                j += 1
            if exchanged is None or exchanged is active[0]:
                break
            stop = exchanged
        y += 1


def fill_poly(img, pts, color, line_type=LINE_8):
    """``cv2.fillPoly`` of ``LINE_8`` (and ``LINE_AA`` on a float image,
    where OpenCV draws it as ``LINE_8``) on integer points: any polygons,
    convex or not, filled by the even-odd rule through OpenCV's edge list."""
    _line_type(img, line_type)
    colour = _colour(img, color)
    edges = []
    for poly in pts:
        v = np.asarray(poly).reshape(-1, 2).astype(np.int64).tolist()
        if v:
            _collect_poly_edges(img, v, edges, colour)
    _fill_edge_collection(img, edges, colour)
    return img


def polylines(img, pts, is_closed, color, thickness=1):
    """``cv2.polylines`` of ``LINE_8`` on integer points."""
    colour = _colour(img, color)
    for poly in pts:
        v = np.asarray(poly).reshape(-1, 2).astype(np.int64).tolist()
        if not v:
            continue
        i = len(v) - 1 if is_closed else 0
        flags = 2 + (not is_closed)
        p0 = v[i]
        for p in v[(0 if is_closed else 1):]:
            if thickness <= 1:
                ys, xs = line_pixels(img.shape[1], img.shape[0], p0, p)
                _paint(img, ys, xs, colour)
            else:
                _thick_line(img, p0, p, colour, thickness, flags)
            p0 = p
            flags = 2
    return img


_GLYPHS = {}


def _glyph_table(thickness, font_scale=1):
    """(advances, [(x, y, bitmap)]) of the weight that `thickness` selects
    at `font_scale`."""
    from gims_tpu_torch.core import text_glyphs

    name = text_glyphs.SCALES[font_scale][1 if thickness <= 1 else 2]
    if name is None:
        raise NotImplementedError(f"text at fontScale {font_scale} of thickness {thickness}: "
                                  "that weight is not carried (ROADMAP.md §1)")
    if name not in _GLYPHS:
        advances = getattr(text_glyphs, f"{name}_ADVANCES")
        offsets = getattr(text_glyphs, f"{name}_OFFSETS")
        blob = np.frombuffer(zlib.decompress(base64.b64decode(
            "".join(getattr(text_glyphs, f"{name}_BITMAPS")))), np.uint8)
        glyphs, pos = [], 0
        for x, y, gh, gw in offsets:
            glyphs.append((x, y, blob[pos:pos + gh * gw].reshape(gh, gw)))
            pos += gh * gw
        _GLYPHS[name] = (advances, glyphs)
    return _GLYPHS[name]


def _check_font(text, font_face, font_scale):
    from gims_tpu_torch.core import text_glyphs

    if font_face != FONT_HERSHEY_SIMPLEX or font_scale not in text_glyphs.SCALES:
        raise NotImplementedError(
            f"text of font {font_face} at scale {font_scale}: only FONT_HERSHEY_SIMPLEX at "
            "fontScale 1 and 0.7, as OpenCV 5 draws it, is ported (ROADMAP.md §1)")
    codes = [ord(c) for c in text]
    if any(c < 32 or c > 126 for c in codes):
        raise NotImplementedError("text outside printable ASCII is not ported (ROADMAP.md §1)")
    return [c - 32 for c in codes]


def get_text_size(text, font_face, font_scale, thickness):
    """``cv2.getTextSize``: ((width, height), baseline)."""
    from gims_tpu_torch.core import text_glyphs

    codes = _check_font(text, font_face, font_scale)
    advances, glyphs = _glyph_table(thickness, font_scale)
    if not codes:
        return (0, 0), 0
    width = sum(advances[c] for c in codes) + 1
    baseline = max([0] + [glyphs[c][1] + glyphs[c][2].shape[0] for c in codes
                          if glyphs[c][2].size])
    return (width, text_glyphs.SCALES[font_scale][0]), baseline


def put_text(img, text, org, font_face, font_scale, color, thickness=1, line_type=LINE_8):
    """``cv2.putText`` with the pen starting at `org` on the baseline."""
    codes = _check_font(text, font_face, font_scale)
    if line_type not in (LINE_8, LINE_AA):
        raise NotImplementedError(f"text of line type {line_type} is not ported")
    advances, glyphs = _glyph_table(thickness, font_scale)
    colour = _colour(img, color).astype(np.int32)
    h, w = img.shape[:2]
    pen_x, pen_y = int(org[0]), int(org[1])
    for c in codes:
        gx, gy, bitmap = glyphs[c]
        x0, y0 = pen_x + gx, pen_y + gy
        pen_x += advances[c]
        gh, gw = bitmap.shape
        ya, yb = max(y0, 0), min(y0 + gh, h)
        xa, xb = max(x0, 0), min(x0 + gw, w)
        if ya >= yb or xa >= xb:
            continue
        a = bitmap[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)
        region = img[ya:yb, xa:xb]
        if img.ndim == 3:
            a = a[..., None]
            c_ = colour
        else:
            c_ = colour[0]
        region[...] = ((region.astype(np.int32) * (255 - a) + c_ * a + 127) // 255
                       ).astype(np.uint8)
    return img
