"""K1's dispatch (``matcher/attention.takes_kernel``), decided on the CPU
for a CUDA device: "auto" hands every head width to the kernel's wrapper
(the wide-head kernel above KERNEL_MAX_HEAD_DIM, 256), as the JAX package
takes its TPU kernel at any width; "pallas" always goes to the wrapper; a
call that needs a gradient and the CPU take the plain versions. On the CPU,
a head of 320 through "auto" equals the JAX package's attention within 1e-5
(f32 sums in another order), and so does the kernel's plain version
(``masked_attention_tiled``, what its wrapper runs on a CPU tensor).
"""

import numpy as np
import pytest
import torch

from gims_tpu.matcher.attention import masked_attention as jax_attention
from gims_tpu_torch.matcher import attention, cuda_attention
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("impl,grad,want", [
    ("auto", False, True), ("pallas", False, True), ("pallas", True, True),
    ("auto", True, False), ("direct", False, False), ("flash", False, False)])
def test_takes_kernel_on_cuda(impl, grad, want):
    assert attention.takes_kernel("cuda", impl, grad) is want


def test_cpu_never_takes_kernel_under_auto():
    assert not attention.takes_kernel("cpu", "auto")


def _wide_inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, n, 2, 320).astype(np.float32) for n in (40, 57, 57))
    return q, k, v, rng.rand(1, 57) < 0.8


def test_wide_head_auto_equals_jax():
    q, k, v, mask = _wide_inputs()
    got = attention.masked_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                     impl="auto")
    want = np.asarray(jax_attention(q, k, v, mask, impl="auto"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_wide_head_kernel_plain_version_equals_jax():
    q, k, v, mask = _wide_inputs()
    got = cuda_attention.masked_attention_cuda(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    want = np.asarray(jax_attention(q, k, v, mask, impl="auto"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
