"""Windowed-sinc interpolation and Brent maximization, batched over lanes.

Port of voxtpu.sinc (reference: `interpolate_sinc`, `brent_maximize`,
`improve_extremum`, periodic.rs:29-230), with the same reference quirks:
the depth clips and the asymmetric upper clip, the Hann taper denominators
over the clipped depth, index clamping, the 1e-10 integer-snap returns,
Brent's `q = 2q - t` denominator (periodic.rs:140), and sin(pi(phi+n))
evaluated as sin(pi*phi) * (-1)^n.

`brent_maximize_sinc` dispatches through `voxtpu_torch.ops.refine`: the
hand-written CUDA kernel for tensors on the card, the plain torch loop
(built on `_WindowEval` below) for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch

from voxtpu_torch.ops.refine import refine

__all__ = ["interpolate_sinc", "brent_maximize_sinc", "improve_extremum_sinc"]


def _max_effective_depth(offset: int, nx: int, max_depth: int, max_x: float) -> int:
    """Static bound on the clipped depth, for tap sizing (voxtpu.sinc)."""
    on_max = offset + int(math.floor(max_x)) + 1
    return min(max_depth, max(on_max + 1, 0))


def _clipped_depth(nl_i, offset, max_depth, T):
    """The reference's low depth clip, bounded by the tap count T."""
    md = torch.clamp(offset + nl_i + 1, min=0)
    return torch.clamp(md, max=min(int(max_depth), int(T)))


def _taps(T: int, like: torch.Tensor):
    n = torch.arange(T + 1, device=like.device)
    tap = n.to(like.dtype)
    sign = (1 - 2 * (n % 2)).to(like.dtype)  # (-1)^n
    return n, tap, sign


def _coefs(phi, md, n, tap, sign):
    """Tap coefficients sin(pi(phi+n))/(pi(phi+n)) * Hann taper, zero past md."""
    a = math.pi * (phi[..., None] + tap)
    coef = (torch.sin(math.pi * phi)[..., None] * sign / a) * (
        0.5 + 0.5 * torch.cos(a / (phi + md.to(phi.dtype))[..., None])
    )
    return torch.where(n <= md[..., None], coef, torch.zeros_like(coef))


def _gather(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y (B, L) read at idx (B, ...) clamped into [0, L)."""
    B, L = y.shape
    idx = torch.clamp(idx, 0, L - 1)
    return torch.gather(y, 1, idx.reshape(B, -1)).reshape(idx.shape)


def interpolate_sinc(
    y: torch.Tensor,
    offset: int,
    nx: int,
    x: torch.Tensor,
    max_depth: int,
    max_x: float | None = None,
) -> torch.Tensor:
    """Windowed-sinc interpolation of y (B, L) at real positions x (B, C)."""
    L = y.shape[-1]
    if max_x is None:
        max_x = float(nx)
    T = _max_effective_depth(offset, nx, max_depth, max_x)
    n, tap, sign = _taps(T, y)

    nl = torch.floor(x)
    nr = nl + 1.0
    phil = x - nl
    phir = 1.0 - phil
    nl_i = nl.long()
    md = _clipped_depth(nl_i, offset, max_depth, T)

    idx_l = torch.clamp(offset + nr.long()[..., None] - n, min=0)
    idx_r = offset + nl_i[..., None] + n
    result = torch.sum(_gather(y, idx_l) * _coefs(phil, md, n, tap, sign), dim=-1) + \
        torch.sum(_gather(y, idx_r) * _coefs(phir, md, n, tap, sign), dim=-1)

    # Early-return cases (periodic.rs:38-42).
    y_last_window = y[:, min(max(offset + nx - 1, 0), L - 1)][:, None]
    y_first = y[:, :1]
    result = torch.where(torch.abs(x - nr) < 1.0e-10, _gather(y, offset + nl_i + 1), result)
    result = torch.where(torch.abs(x - nl) < 1.0e-10, _gather(y, offset + nl_i), result)
    result = torch.where(x < 0.0, y_first.expand_as(result), result)
    result = torch.where(x > nx, y_last_window.expand_as(result), result)
    return result


class _WindowEval:
    """Sinc evaluation for Brent refinement around fixed starts x0.

    During Brent the point moves within (x0-1, x0+1), so floor(x) - floor(x0)
    is in {-1, 0, +1}; voxtpu.sinc._WindowEval materializes that window once
    and clips the shift to it. Here each eval gathers straight from y at the
    same clipped indices: left tap n reads y[offset + K + s + 1 - n], right
    tap n reads y[offset + K + s + n], K = floor(x0), s = clip(floor(x) - K,
    -1, 1), every index clamped into [0, L).
    """

    def __init__(self, y: torch.Tensor, offset: int, x0: torch.Tensor, max_depth: int,
                 taps: int):
        self.y = y
        self.offset = offset
        self.max_depth = max_depth
        self.T = taps - 1
        self.K = torch.floor(x0).long()
        self.n, self.tap, self.sign = _taps(self.T, y)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nl = torch.floor(x)
        nl_i = nl.long()
        s = torch.clamp(nl_i - self.K, -1, 1)
        phil = x - nl
        phir = 1.0 - phil
        md = _clipped_depth(nl_i, self.offset, self.max_depth, self.T)

        base = self.offset + self.K + s  # y index of right tap 0 (== y[offset + nl])
        lvals = _gather(self.y, base[..., None] + 1 - self.n)
        rvals = _gather(self.y, base[..., None] + self.n)
        lsum = torch.sum(lvals * _coefs(phil, md, self.n, self.tap, self.sign), dim=-1)
        rsum = torch.sum(rvals * _coefs(phir, md, self.n, self.tap, self.sign), dim=-1)
        result = lsum + rsum

        # Integer-snap early returns (periodic.rs:41-42).
        result = torch.where(torch.abs(x - (nl + 1.0)) < 1e-10, _gather(self.y, base + 1), result)
        result = torch.where(torch.abs(x - nl) < 1e-10, _gather(self.y, base), result)
        return result


def brent_maximize_sinc(
    y: torch.Tensor,
    offset: int,
    nx: int,
    ixmid: torch.Tensor,
    max_depth: int,
    tol: float = 1e-10,
    max_x: float | None = None,
    iters: int = 60,
    lane_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brent maximization of the sinc interpolant on (ixmid-1, ixmid+1),
    batched over (B, C) lanes (periodic.rs:103-188). Returns (x, fx).

    Masked-off lanes start converged and return (v0, f(v0)), as in voxtpu.
    iters=0 evaluates f at ixmid instead (the kernel's evaluation-only mode).
    """
    T = _max_effective_depth(offset, nx, max_depth, max_x if max_x is not None else float(nx))
    if lane_mask is None:
        lane_mask = torch.ones_like(ixmid, dtype=torch.bool)
    return refine(y, ixmid, lane_mask, offset, max_depth, T, iters=iters, tol=tol)


def improve_extremum_sinc(
    y: torch.Tensor,
    offset: int,
    nx: int,
    ixmid: torch.Tensor,
    max_depth: int,
    max_x: float | None = None,
    lane_mask: torch.Tensor | None = None,
    is_max: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """improve_extremum, Sinc branch (periodic.rs:193-228), batched.

    Edge cases ixmid == 0 / ixmid >= nx (periodic.rs:193-194) are selects.
    is_max=False runs Brent on the negated interpolant, as voxtpu does.
    """
    yb = y if is_max else -y
    xb, fb = brent_maximize_sinc(yb, offset, nx, ixmid, max_depth, max_x=max_x,
                                 lane_mask=lane_mask)
    L = y.shape[-1]
    y0 = y[:, :1].expand_as(xb)
    y_last = y[:, min(nx - 1, L - 1)][:, None].expand_as(xb)
    at_zero = ixmid == 0.0
    past_end = ixmid >= nx
    xmid = torch.where(at_zero, torch.zeros_like(xb),
                       torch.where(past_end, torch.full_like(xb, float(nx)), xb))
    ymid = torch.where(at_zero, y0, torch.where(past_end, y_last, fb))
    return xmid, ymid
