"""The deterministic segmented sum (``core/segsum.py``, kernel
``csrc/segsum.cu``) on the CPU, where each caller takes the plain version.

- ``segment_sum`` and ``batched_segment_sum`` equal a sequential float32
  numpy sum (``np.add.at`` into zeros, in source order) to the bit, in the
  callers' patterns: runs of equal slots (SIFT's votes), long segments (the
  loss's pairs), empty slots, signed zeros.
- AGC's ``_segment_sum`` takes it for floats and keeps ``scatter_add_`` for
  integers; both equal numpy's sums.
- The training loss's per-pair sums: the value and the gradient through
  ``segment_sum`` (each value's gradient is its slot's).
- The SIFT descriptors on the CPU are unchanged when their histograms are
  summed by numpy's sequential ``np.add.at`` in place of ``segment_sum``:
  the sum the card now computes is the one ``tests/test_torch_sift.py``
  holds to ``cv2.SIFT``.
- The wrapper refuses what the kernel does not take, and a CPU tensor never
  reaches the kernel.
No tolerance: every comparison is equality.
"""

import numpy as np
import pytest
import torch

from gims_tpu_torch.agc.graph import _segment_sum
from gims_tpu_torch.core import segsum
from gims_tpu_torch.frontend import sift
from gims_tpu_torch.synthetic import synthetic_image_pair
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def numpy_sum(values, index, num):
    out = np.zeros(num, np.float32)
    np.add.at(out, index, values.astype(np.float32))
    return out


@pytest.mark.parametrize("n,num,dup", [(1, 1, 1), (1000, 37, 5), (200_000, 20_000, 8),
                                       (50_000, 3, 1)])
def test_segment_sum_equals_sequential_numpy(n, num, dup):
    rng = np.random.default_rng(n)
    idx = np.repeat(rng.integers(0, num, size=(n + dup - 1) // dup), dup)[:n]
    vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, size=n)).astype(np.float32)
    vals[::97] = -0.0
    got = segsum.segment_sum(torch.from_numpy(vals), torch.from_numpy(idx), num)
    assert got.dtype == torch.float32 and got.shape == (num,)
    np.testing.assert_array_equal(got.numpy(), numpy_sum(vals, idx, num))
    assert segsum.launches == 0


def test_batched_and_agc_segment_sums():
    rng = np.random.default_rng(0)
    data = (rng.random((3, 700)) * 800).astype(np.float32)
    seg = rng.integers(0, 41, (3, 700))
    want = np.stack([numpy_sum(data[b], seg[b], 41) for b in range(3)])
    got = segsum.batched_segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 41)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 41).numpy(), want)
    ints = rng.integers(0, 2, (3, 700))
    counts = _segment_sum(torch.from_numpy(ints), torch.from_numpy(seg), 41)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(),
                                  np.stack([np.bincount(seg[b], ints[b], 41) for b in range(3)]))


def test_loss_sums_and_gradient():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random(5000, dtype=np.float32), requires_grad=True)
    rows = torch.from_numpy(np.sort(rng.integers(0, 4, 5000)))
    coef = torch.tensor([1.0, -2.0, 0.5, 3.0])
    sums = segsum.segment_sum(x * 2.0, rows, 4)
    np.testing.assert_array_equal(sums.detach().numpy(),
                                  numpy_sum((x * 2.0).detach().numpy(), rows.numpy(), 4))
    (grad,) = torch.autograd.grad((sums * coef).sum(), x)
    assert torch.equal(grad, coef[rows] * 2.0)


def test_sift_descriptors_use_the_sequential_sum(monkeypatch):
    img = synthetic_image_pair(3, (120, 160), colour=True)[0]
    cpu = sift.SIFT(3, 0.001, 80, 1.6, device="cpu")
    kp = sift.filter_top_responses(cpu.detect_raw(img)[0], 300)
    got = cpu.compute(img, kp)

    calls = []

    def sequential(values, index, num, tag):
        calls.append(len(values))
        return torch.from_numpy(numpy_sum(values.numpy(), index.numpy(), num))

    monkeypatch.setattr(sift, "segment_sum", sequential)
    assert np.array_equal(cpu.compute(img, kp), got) and got.shape == (300, 128)
    assert calls and sum(calls) >= 300 * 8


def test_wrapper_refuses():
    v, i = torch.ones(4), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        segsum.segment_sum(v.double(), i, 2)
    with pytest.raises(ValueError):
        segsum.segment_sum(v, i[:3], 2)
    with pytest.raises(ValueError, match="device"):
        segsum.segment_sum_cuda(v, i, 2)
