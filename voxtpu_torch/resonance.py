"""Complex LPC roots -> resonances (formant candidates).

Port of voxtpu.resonance (reference: `Resonance::from_root`, `ToResonance`,
spectrum.rs:149-210): one elementwise pass maps roots to (frequency,
bandwidth, valid); a stable sort packs the valid ones to the front.
"""

from __future__ import annotations

import math

import torch

from voxtpu_torch.cplx import C, cconj, cinv, to_polar

__all__ = ["resonances_from_roots", "sort_and_pack_resonances"]


def resonances_from_roots(
    roots: C, sample_rate: float, require_im_positive: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map roots to (frequency, bandwidth, valid), elementwise
    (spectrum.rs:166-192): |z| > 1 reflects inside the unit circle via
    conj(z)^-1; freq = theta sr / 2pi, bw = -2 ln(r) sr / 2pi; valid keeps
    im > 0 (>= 0 with require_im_positive=False), 50 < freq < nyquist - 50,
    and finite values. Invalid entries are zero."""
    freq_mul = sample_rate / (2.0 * math.pi)
    r, theta = to_polar(roots)
    r2, theta2 = to_polar(cinv(cconj(roots)))
    outside = r > 1.0
    r = torch.where(outside, r2, r)
    theta = torch.where(outside, theta2, theta)

    freq = freq_mul * theta
    bw = -2.0 * freq_mul * torch.log(r)
    im_ok = roots.im > 0 if require_im_positive else roots.im >= 0
    valid = im_ok & (freq > 50.0) & (freq < sample_rate * 0.5 - 50.0)
    valid = valid & torch.isfinite(freq) & torch.isfinite(bw)
    return torch.where(valid, freq, 0.0), torch.where(valid, bw, 0.0), valid


def sort_and_pack_resonances(
    freq: torch.Tensor, bw: torch.Tensor, valid: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid resonances first, ascending by frequency (ties in root order),
    invalid ones zeroed at the back, cut or zero-padded to `capacity`
    (lib.rs:55, 94-111)."""
    key = torch.where(valid, freq, math.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    valid_s = torch.gather(valid, -1, order)
    freq_s = torch.where(valid_s, torch.gather(freq, -1, order), 0.0)
    bw_s = torch.where(valid_s, torch.gather(bw, -1, order), 0.0)
    n = freq.shape[-1]
    if n >= capacity:
        return freq_s[..., :capacity], bw_s[..., :capacity]
    pad = (0, capacity - n)
    return torch.nn.functional.pad(freq_s, pad), torch.nn.functional.pad(bw_s, pad)
