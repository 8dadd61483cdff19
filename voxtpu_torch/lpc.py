"""Batched LPC: Levinson-Durbin and Burg ("praat") recursions.

Port of voxtpu.lpc (reference: spectrum.rs:50-147). `burg` runs Burg's
method per frame through kernel B (voxtpu_torch.ops.burg): the CUDA kernel
for frames on the card, the plain PyTorch recursion for frames on the CPU.
A frame where an order hits `denum <= 0` is flagged in the per-frame status
(`errors.LPC_DENUM_NONPOS`) instead of raising.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import burg as _burg

__all__ = ["levinson", "burg"]


def levinson(ac: torch.Tensor, n_coeffs: int) -> torch.Tensor:
    """Levinson-Durbin on (..., m) autocorrelations, m >= n_coeffs + 1
    (`LPC::lpc_mut`, spectrum.rs:63-84): returns (..., n_coeffs + 1) with
    a[0] = 1."""
    if ac.shape[-1] < n_coeffs + 1:
        raise ValueError("need at least n_coeffs+1 autocorrelation values")
    one = torch.ones(ac.shape[:-1] + (1,), dtype=ac.dtype, device=ac.device)
    a = one
    err = ac[..., 0]
    for i in range(1, n_coeffs + 1):
        acc = ac[..., i]
        if i > 1:
            acc = acc + torch.sum(a[..., 1:i] * ac[..., 1:i].flip(-1), dim=-1)
        k = -acc / err
        body = a[..., 1:i] + k[..., None] * a[..., 1:i].flip(-1) if i > 1 else a[..., 1:i]
        a = torch.cat([one, body, k[..., None]], dim=-1)
        err = err * (1.0 - k * k)
    return a


def burg(x: torch.Tensor, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Burg LPC of (..., N) windowed samples, reference-exact
    (`lpc_praat_mut`, spectrum.rs:101-146). Returns (coeffs (..., n_coeffs),
    sign-flipped as in the reference; status (...,) int32)."""
    batch = x.shape[:-1]
    coeffs, status = _burg.burg(x.reshape(-1, x.shape[-1]), n_coeffs)
    return coeffs.reshape(batch + (int(n_coeffs),)), status.reshape(batch)
