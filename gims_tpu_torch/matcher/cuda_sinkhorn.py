"""Log-domain Sinkhorn through the hand-written CUDA kernel.

Port of ``gims_tpu/matcher/pallas_sinkhorn.py``. The kernel
(``csrc/sinkhorn.cu``) computes the potentials (u, v); the wrapper forms
Z + u + v - norm as the JAX wrapper does. On a CUDA tensor the wrapper
launches the kernel or raises. It takes the plain version
(``sinkhorn.log_sinkhorn_uv``) only for a tensor on the CPU.

The kernel reads rows of Z that start 16-byte aligned, in a row pitch of N1
rounded up to 4 floats; it never reads the pad. ``log_optimal_transport_cuda``
builds the couplings in that layout; the wrapper copies a contiguous Z
into it (one pass over Z, against the 100 of the kernel). The kernel is
picked by size in C: one read of Z per iteration up to 14340 columns, two
beyond, and where the batch has more items than the card has blocks.

The kernel has no backward, as the TPU kernel has none. Adding its
potentials to Z as constants would give Z a wrong gradient (it would miss
how u and v depend on the scores), so under autograd (grad enabled and an
input that requires grad) both wrappers raise, on any device; training
runs ``sinkhorn.log_optimal_transport`` (``use_pallas_sinkhorn=False``).
"""

from __future__ import annotations

import torch

from gims_tpu_torch import _build
from gims_tpu_torch.matcher import sinkhorn
from gims_tpu_torch.matcher.attention import needs_grad

# calls of sinkhorn_uv_cuda that launched the kernel (one cooperative
# launch runs every iteration)
launches = 0


def sinkhorn_uv_cuda(Z: torch.Tensor, log_mu: torch.Tensor,
                     log_nu: torch.Tensor, iters: int):
    """(u, v) Sinkhorn potentials. Z (B, M1, N1), log_mu (B, M1),
    log_nu (B, N1), f32 on one device; the marginals contiguous, Z
    contiguous or a view of rows of N1 rounded up to 4 floats."""
    global launches
    if needs_grad(Z, log_mu, log_nu):
        raise RuntimeError("sinkhorn_uv_cuda has no backward: an input requires grad "
                           "with grad enabled")
    if Z.device.type == "cpu":
        return sinkhorn.log_sinkhorn_uv(Z, log_mu, log_nu, iters)
    if Z.device.type != "cuda":
        raise ValueError(f"sinkhorn_uv_cuda: unsupported device {Z.device}")
    if Z.dim() != 3:
        raise ValueError(f"Z must be (B, M1, N1), got {tuple(Z.shape)}")
    b, m1, n1 = Z.shape
    if tuple(log_mu.shape) != (b, m1) or tuple(log_nu.shape) != (b, n1):
        raise ValueError(
            f"marginal shapes {tuple(log_mu.shape)}, {tuple(log_nu.shape)} "
            f"do not fit Z {tuple(Z.shape)}")
    for name, t in (("Z", Z), ("log_mu", log_mu), ("log_nu", log_nu)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if name != "Z" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ldz = n1 + -n1 % 4
    if Z.stride() != (m1 * ldz, ldz, 1) or Z.data_ptr() % 16:
        if not Z.is_contiguous():
            raise ValueError(f"Z must be contiguous or in rows of {ldz} floats, "
                             f"got strides {Z.stride()}")
        Zp = Z.new_empty((b, m1, ldz))[:, :, :n1]
        Zp.copy_(Z)
        Z = Zp
    u = torch.empty((b, m1), dtype=torch.float32, device=Z.device)
    v = torch.empty((b, n1), dtype=torch.float32, device=Z.device)
    lib = _build.load()
    with torch.cuda.device(Z.device):
        # (max, sum) column partials of every band, as float2
        n_scratch = lib.gims_sinkhorn_scratch_len(b, m1, n1)
        if n_scratch < 0:
            raise ValueError(f"gims_sinkhorn_scratch_len({b}, {m1}, {n1}) failed: "
                             f"cudaError {-n_scratch}")
        scratch = torch.empty((n_scratch, 2), dtype=torch.float32, device=Z.device)
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = lib.gims_sinkhorn_uv(Z.data_ptr(), log_mu.data_ptr(),
                                  log_nu.data_ptr(), u.data_ptr(),
                                  v.data_ptr(), scratch.data_ptr(), n_scratch,
                                  b, m1, n1, int(iters), stream)
    if rc != 0:
        raise RuntimeError(f"gims_sinkhorn_uv failed: cudaError {rc}")
    launches += 1
    return u, v


def z_reads_per_iter(b: int, m1: int, n1: int) -> int:
    """Reads of Z per iteration of the kernel picked for Z (b, m1, n1) on
    the current card: 1 (fused) or 2 (streaming)."""
    reads = _build.load().gims_sinkhorn_z_reads(b, m1, n1)
    if reads < 0:
        raise ValueError(f"gims_sinkhorn_z_reads({b}, {m1}, {n1}) failed: cudaError {-reads}")
    return reads


def log_optimal_transport_cuda(scores: torch.Tensor, alpha, iters: int,
                               row_mask: torch.Tensor,
                               col_mask: torch.Tensor) -> torch.Tensor:
    """Drop-in for sinkhorn.log_optimal_transport at inference; returns the
    same (B, M+1, N+1) log-coupling. Raises under autograd."""
    if needs_grad(scores, *([alpha] if torch.is_tensor(alpha) else [])):
        raise RuntimeError("log_optimal_transport_cuda has no backward: scores or the bin "
                           "score requires grad with grad enabled; train with "
                           "use_pallas_sinkhorn=False")
    n1 = scores.shape[2] + 1
    couplings, log_mu, log_nu, norm = sinkhorn.dustbin_couplings(
        scores, alpha, row_mask, col_mask, row_pitch=n1 + -n1 % 4)
    u, v = sinkhorn_uv_cuda(couplings, log_mu.contiguous(), log_nu.contiguous(), iters)
    Z = couplings + u[:, :, None] + v[:, None, :]
    return Z - norm[:, None, None]
