"""The segmented sum by rows (``core/segsum.py::segment_sum_rows``, kernel
``csrc/segsum.cu``) on the CPU, where the wrapper takes the plain version.

The kernel cannot run here, so its order of adds is mirrored in numpy
(``kernel_order_sum``), in both of its ways: each row, or each range of a
row's slots (a part), walked in steps of 32 values; by group, in each step
the values of one slot added by the group's first lane to the slot's
running sum, then its peers' in lane order, values of +0 and -0 left out;
by lane, the lane that owns a slot adds its values in source order. That
mirror is held bit-equal to numpy's sequential ``np.add.at`` (source order)
and to ``segment_sum_plain`` (``index_add_``) at the three callers' row
layouts, in both ways and at part counts from one a row to one a slot
(whichever of them the kernel's launcher picks for a shape):

- SIFT: a row per keypoint, samples x 8 votes into 361 slots (int16),
  consecutive samples in the same bins (runs), masked samples voting zeros
  (+0 and -0) into one cell;
- AGC's centroid sums: a row per image and coordinate, N values into C + 1
  slots (int32), a component holding half the nodes (long runs), pruned
  nodes' zeros in slot C, empty slots;
- the training loss: four rows over one slot list (row stride 0) into B
  slots, each pair a long run, entries of weight 0.

No tolerance: every comparison is equality. The wrapper's checks and its
CPU route are tested too.
"""

import numpy as np
import pytest
import torch

from gims_tpu_torch.core import segsum
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

def kernel_order_sum(values, slots, num, parts, by_lane=False):
    """csrc/segsum.cu's adds in its order, in float32."""
    rows, width = values.shape
    span = -(-num // parts)
    out = np.zeros((rows, num), np.float32)
    for r in range(rows):
        for lo in range(0, num, span):
            hi = min(num, lo + span)
            sums = np.zeros(hi - lo, np.float32)
            if by_lane:  # each lane: its slot's values in source order, zeros too
                for mine in range(lo, hi):
                    terms = values[r][slots[r] == mine]
                    chain = np.add.accumulate(np.concatenate([[np.float32(0)], terms]),
                                              dtype=np.float32)  # sequential float32 adds
                    sums[mine - lo] = chain[-1]
                out[r, lo:hi] = sums
                continue
            for base in range(0, width, 32):
                v = values[r, base:base + 32]
                s = slots[r, base:base + 32].astype(np.int64)
                keys = np.where((v != 0) & (s >= lo) & (s < hi), s, -1)
                for key in dict.fromkeys(keys.tolist()):  # groups by their first lane
                    if key < 0:
                        continue
                    lanes = np.flatnonzero(keys == key)
                    acc = np.float32(sums[key - lo] + v[lanes[0]])
                    for lane in lanes[1:]:
                        acc = np.float32(acc + v[lane])
                    sums[key - lo] = acc
            out[r, lo:hi] = sums
    return out


def sequential_sum(values, slots, num):
    """np.add.at into zeros, row by row: the sequential sum in source order."""
    out = np.zeros((values.shape[0], num), np.float32)
    for r in range(values.shape[0]):
        np.add.at(out[r], slots[r].astype(np.int64), values[r])
    return out


def sift_rows(rng, k=6, samples=300):
    """A row per keypoint: each sample's 8 votes into its 2x2x2 cells of
    the (d + 2)^2 (nb + 2) histogram, one slot before it (as
    frontend/sift.py); runs of samples in one cell; masked samples vote
    zeros into cell 0."""
    d, nb = 4, 8
    steps = np.array([0, 1, nb + 2, nb + 3, (d + 2) * (nb + 2), (d + 2) * (nb + 2) + 1,
                      (d + 3) * (nb + 2), (d + 3) * (nb + 2) + 1])
    run = rng.integers(1, 6, size=(k, samples)).cumsum(1) // 4  # neighbours share a cell
    r0 = (run * 7 + rng.integers(0, 2, (k, samples))) % (d + 1) - 1
    c0 = (run * 3) % (d + 1) - 1
    o0 = rng.integers(0, nb, (k, samples))
    masked = rng.random((k, samples)) < 0.3
    r0, c0, o0 = (np.where(masked, 0, x) for x in (r0, c0, o0))
    idx = ((r0 + 1) * (d + 2) + c0 + 1) * (nb + 2) + o0
    slots = (1 + idx[..., None] + steps).astype(np.int16).reshape(k, -1)
    vals = (rng.random((k, samples, 8)) * 10.0 ** rng.integers(-3, 3, (k, samples, 8)))
    vals = np.where(masked[..., None], 0.0, vals).astype(np.float32)
    vals[..., 1] = np.where(masked, -0.0, vals[..., 1])  # signed zeros
    return vals.reshape(k, -1), slots, (d + 2) ** 2 * (nb + 2) + 1


def agc_rows(rng, b=2, n=700, c=60, labels=40):
    """A row per image and coordinate: labels in [0, c] (c: pruned, its
    values 0), half the nodes in one component, labels past `labels`
    unused."""
    lab = rng.integers(0, labels, (b, n))
    lab[:, rng.random(n) < 0.5] = 3
    pruned = rng.random((b, n)) < 0.1
    lab = np.where(pruned, c, lab)
    xy = (rng.random((b, 2, n)) * 800).astype(np.float32)
    xy = np.where(pruned[:, None], 0.0, xy).astype(np.float32)
    slots = np.repeat(lab[:, None], 2, axis=1).reshape(2 * b, n).astype(np.int32)
    return xy.reshape(2 * b, n), slots, c + 1


def loss_rows(rng, rows=5000, batch=3):
    """Four rows (loss * pos_w, pos_w, loss * neg_w, neg_w) over one sorted
    list of pair indices."""
    pair = np.sort(rng.integers(0, batch, rows)).astype(np.int32)
    loss = (rng.random(rows) * 100).astype(np.float32)
    neg = rng.random(rows) < 0.3
    valid = rng.random(rows) < 0.9
    pos_w = (valid & ~neg).astype(np.float32)
    neg_w = (valid & neg).astype(np.float32)
    vals = np.stack([loss * pos_w, pos_w, loss * neg_w, neg_w]).astype(np.float32)
    return vals, np.broadcast_to(pair, (4, rows)), batch


LAYOUTS = {"sift": sift_rows, "agc": agc_rows, "loss": loss_rows}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_order_equals_sequential_sum(layout):
    rng = np.random.default_rng(len(layout))
    vals, slots, num = LAYOUTS[layout](rng)
    want = sequential_sum(vals, slots, num)
    for lane_way in (False, True):
        for p in sorted({1, 2, 3, 7, 33, -(-num // 32), num} & set(range(1, num + 1))):
            if lane_way and -(-num // p) > 32:
                continue  # the lane way owns at most 32 slots a warp
            got = kernel_order_sum(vals, slots, num, p, lane_way)
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = segsum.segment_sum_rows_plain(torch.from_numpy(vals),
                                          torch.from_numpy(np.ascontiguousarray(slots)), num)
    np.testing.assert_array_equal(plain.numpy().view(np.int32), want.view(np.int32))
    flat = segsum.segment_sum_plain(
        torch.from_numpy(vals.reshape(-1)),
        torch.from_numpy((slots.astype(np.int64) + num * np.arange(len(vals))[:, None])
                         .reshape(-1)), len(vals) * num)
    np.testing.assert_array_equal(flat.numpy().reshape(want.shape), want)
    if layout == "agc":
        assert (want[:, 40:num - 1] == 0).all() and (want[:, num - 1] == 0).all()
    if layout == "sift":  # zeros only in the masked cell's slots: +0, never -0
        assert not np.signbit(want[want == 0]).any()


def test_rows_wrapper_on_cpu():
    """segment_sum_rows takes the plain version on a CPU tensor for int16,
    int32 and int64 slots and a slot list of row stride 0, launches
    nothing, and gives each value's slot's gradient."""
    rng = np.random.default_rng(7)
    vals, slots, num = loss_rows(rng, rows=900)
    want = torch.from_numpy(sequential_sum(vals, slots, num))
    before = segsum.launches
    for dtype in (torch.int16, torch.int32, torch.int64):
        shared = torch.from_numpy(slots[0].copy()).to(dtype)[None].expand(4, -1)
        assert shared.stride(0) == 0
        assert torch.equal(segsum.segment_sum_rows(torch.from_numpy(vals), shared, num), want)
    assert segsum.launches == before
    x = torch.from_numpy(vals).requires_grad_()
    idx = torch.from_numpy(slots[0].astype(np.int64))
    coef = torch.arange(1.0, 4 * num + 1).reshape(4, num)
    (grad,) = torch.autograd.grad((segsum.segment_sum_rows(x, idx[None].expand(4, -1), num)
                                   * coef).sum(), x)
    assert torch.equal(grad, coef[:, idx])
    b = segsum.batched_segment_sum(torch.from_numpy(vals), torch.from_numpy(slots.copy()), num)
    assert torch.equal(b, want)


def test_rows_wrapper_refuses():
    v, s = torch.ones(2, 4), torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        segsum.segment_sum_rows_cuda(v, s, 3)
    with pytest.raises(TypeError):
        segsum.segment_sum_rows(v.double(), s, 3)
    with pytest.raises(TypeError):
        segsum.segment_sum_rows(v, s.float(), 3)
    with pytest.raises(ValueError):
        segsum.segment_sum_rows(v, s[:, :3], 3)
    with pytest.raises(ValueError):
        segsum.segment_sum_rows(v[0], s[0], 3)
