"""Wave utilities: RMS, amplitude, normalization, preemphasis.

Port of voxtpu.waves (reference: vox_box src/waves.rs). Every op reduces or
recurs over the trailing sample axis and is batched over the leading axes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rms", "amplitude", "max_amplitude", "normalize", "preemphasis"]


def rms(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Root-mean-square over `dim`: sqrt(sum(x^2)/n). Reference: waves.rs:14-23."""
    return torch.sqrt(torch.mean(torch.square(x), dim=dim))


def amplitude(x: torch.Tensor) -> torch.Tensor:
    """Elementwise absolute value. Reference: waves.rs:29-37."""
    return torch.abs(x)


def max_amplitude(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Maximum absolute value over `dim`. Reference: waves.rs:44-59."""
    return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)


def normalize(x: torch.Tensor, max_amp: torch.Tensor | None = None, dim: int = -1) -> torch.Tensor:
    """Scale so the maximum absolute value becomes 1; a given `max_amp` is used
    as the divisor as-is, sign included (waves.rs:68-76)."""
    if max_amp is None:
        max_amp = max_amplitude(x, dim=dim, keepdim=True)
    return x / max_amp


def preemphasis(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Reference-exact preemphasis over the last axis (waves.rs:86-96).

    The reference runs backwards, adding the already-updated following sample
    scaled by 2*pi*factor:  y[n-1] = x[n-1];  y[i] = x[i] + c * y[i+1].
    A Python loop over samples, batched over the leading axes; it is off the
    main path (MfccConfig.preemphasis_factor defaults to None).
    """
    c = 2.0 * math.pi * factor
    y = x.clone()
    for i in range(x.shape[-1] - 2, -1, -1):
        y[..., i] = x[..., i] + c * y[..., i + 1]
    return y
