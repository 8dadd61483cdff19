"""Kernel B: Burg LPC per frame (csrc/burg.cu; replaces
voxtpu/ops/burg_pallas.py's `burg_pallas`).

`burg_plain` is the PyTorch version of `voxtpu.lpc.burg` (the reference's
lpc_praat_mut, spectrum.rs:101-146), batched over frames with the order
recursion unrolled. `burg` runs it for CPU tensors and launches the kernel,
one thread block per frame, for CUDA tensors.

Both accumulate each order's two sums (num, denum) and its reflection
coefficient in float64, also for float32 frames; b1, b2 and the coefficients
stay in the frames' dtype. A float32 sum over a frame of 2205 samples lands
on a value that depends on the summation order, and Burg's coefficients,
and the formants from their roots, are sensitive to it: with float32 sums, the
kernel and this version, each summing in its own order, put one formant of
the 44.1 kHz CLI default slice over 1.4 Hz apart (NVIDIA H100 80GB HBM3,
700 W). In float64 the order no longer shows in the float32 result.
"""

from __future__ import annotations

import torch

from voxtpu_torch import errors
from voxtpu_torch.ops import kernels

__all__ = ["burg_plain", "burg"]

_MAX_ORDER = 64  # csrc/burg.cu kMaxOrder


def burg_plain(x: torch.Tensor, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Burg LPC of (..., N) frames: (coeffs (..., P) sign-flipped as in the
    reference, status (...,) int32 with LPC_DENUM_NONPOS where an order hit
    denum <= 0; such frames divide by 1 there and keep best-effort values)."""
    n = x.shape[-1]
    p = int(n_coeffs)
    if n < 2:
        raise ValueError("burg needs at least 2 samples per frame")
    batch = x.shape[:-1]
    zeros1 = torch.zeros(batch + (1,), dtype=x.dtype, device=x.device)
    # b1 = [x[0] .. x[n-2], 0], b2 = [x[1] .. x[n-1], 0]
    b1 = torch.cat([x[..., : n - 1], zeros1], dim=-1)
    b2 = torch.cat([x[..., 1:], zeros1], dim=-1)

    coeffs = torch.zeros(batch + (p,), dtype=x.dtype, device=x.device)
    aa = torch.zeros_like(coeffs)
    status = torch.zeros(batch, dtype=torch.int32, device=x.device)
    for i in range(1, p + 1):
        m = n - i  # active samples this order
        # num, denum and ci in float64 for every dtype, as the kernel does.
        u, v = b1[..., :m].double(), b2[..., :m].double()
        num = torch.sum(u * v, dim=-1)
        denum = torch.sum(u**2 + v**2, dim=-1)
        bad = denum <= 0
        status = torch.where(bad, status | errors.LPC_DENUM_NONPOS, status)
        ci = (2.0 * num / torch.where(bad, torch.ones_like(denum), denum)).to(x.dtype)

        # coeffs[i-1] = ci; coeffs[j-1] = aa[j-1] - ci * aa[i-j-1], j < i
        head = aa[..., : i - 1] - ci[..., None] * aa[..., : i - 1].flip(-1)
        coeffs = torch.cat([head, ci[..., None], coeffs[..., i:]], dim=-1)
        if i < p:
            aa = torch.cat([coeffs[..., :i], aa[..., i:]], dim=-1)
            c = ci[..., None]
            # b2[k] reads the pre-update b1[k+1] (spectrum.rs:135-138).
            b1, b2 = (
                b1 - c * b2,
                torch.cat([b2[..., 1:], zeros1], dim=-1) - c * torch.cat([b1[..., 1:], zeros1], dim=-1),
            )
    return -coeffs, status


def burg(x: torch.Tensor, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`burg_plain` for CPU tensors; on the card, csrc/burg.cu over (B, N)."""
    if kernels.on_cpu(x):
        return burg_plain(x, n_coeffs)
    p = int(n_coeffs)
    if x.dim() != 2 or x.shape[-1] < 2 or not 1 <= p <= _MAX_ORDER:
        raise ValueError(f"burg: x (B, N >= 2) and 1 <= order <= {_MAX_ORDER}; got {x.shape}, {p}")
    B, N = x.shape
    x = x.contiguous()
    coef = torch.empty((B, p), dtype=x.dtype, device=x.device)
    status = torch.empty((B,), dtype=torch.int32, device=x.device)
    kernels.launch("vt_burg", x.dtype, x, coef, status, B, N, p)
    burg.launches += 1
    return coef, status


burg.launches = 0
