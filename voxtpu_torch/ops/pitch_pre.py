"""Kernel G: the pitch pre-stage (csrc/pitch_pre.cu; replaces
voxtpu/ops/pitch_pre_pallas.py's `pitch_pre_pallas`).

`pitch_pre_plain` is the PyTorch version: steps 1-3 of
voxtpu.pitch.pitch_frames (periodic.rs:400-439) in their op order, with the
lag-indexed outputs of the TPU kernel. `pitch_pre` runs it for CPU tensors
and launches the kernel, one thread block per frame, for CUDA tensors. The
outputs are bit-identical: the kernel repeats every operation in the same
order and precision (see the note in csrc/pitch_pre.cu). Unlike the TPU
kernel it takes every frame length: the TPU kernel's shape gate was a
Mosaic tile-walk limit, not semantics.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import kernels

__all__ = ["pitch_pre_plain", "pitch_pre"]


def pitch_pre_plain(
    ac: torch.Tensor, hl: torch.Tensor, bi: int, sample_rate: float, fmin: float, fmax: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, n) quirked autocorrelation and the (n,) HanningLag table ->
    (self_lag (B, 2n), freq (B, bi), cand (B, bi) bool), lag-indexed.

    self_lag is ac normalised by its row's max |ac|, divided by hl, zeroed
    where not finite, then zero-padded to 2n. cand marks the strict 3-point
    maxima at lags 1..bi-2 whose parabolic frequency passes the band
    filter; freq is that frequency, zeroed outside cand."""
    B, n = ac.shape
    dt, dev = ac.dtype, ac.device

    # --- lag-domain normalized autocorrelation (periodic.rs:400-411)
    self_lag = ac / torch.amax(torch.abs(ac), dim=-1, keepdim=True)
    self_lag = self_lag / hl
    # All-zero frames normalize to 0/0: zero the row (no band-passed maxima,
    # the unvoiced candidate wins) so no NaN reaches the refine kernel.
    self_lag = torch.where(torch.isfinite(self_lag), self_lag, 0.0)
    self_lag = torch.cat([self_lag, torch.zeros_like(self_lag)], dim=-1).contiguous()

    freq = torch.zeros((B, bi), dtype=dt, device=dev)
    cand = torch.zeros((B, bi), dtype=torch.bool, device=dev)
    if bi < 3:
        return self_lag, freq, cand

    # --- local maxima over self_lag[0..bi) (periodic.rs:413-417)
    seg = self_lag[:, :bi]
    peak, peak_rev, peak_fwd = seg[:, 1:-1], seg[:, :-2], seg[:, 2:]
    is_max = (peak_rev < peak) & (peak_fwd < peak)  # centers 1..bi-2
    ix = torch.arange(1, bi - 1, device=dev)

    # --- parabolic frequency (periodic.rs:420-425)
    dr = 0.5 * (peak_fwd - peak_rev)
    d2r = 2.0 * peak - (peak_rev - peak_fwd)
    f = sample_rate / (ix.to(dt)[None, :] + dr / d2r)

    # --- band filter (periodic.rs:439)
    c = is_max & ((f == 0.0) | ((f > fmin) & (f < fmax)))
    freq[:, 1 : bi - 1] = torch.where(c, f, 0.0)
    cand[:, 1 : bi - 1] = c
    return self_lag, freq, cand


def pitch_pre(
    ac: torch.Tensor, hl: torch.Tensor, bi: int, sample_rate: float, fmin: float, fmax: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`pitch_pre_plain` for CPU tensors; on the card, csrc/pitch_pre.cu over
    (B, n) rows, any n, 0 <= bi <= n."""
    if kernels.on_cpu(ac, hl):
        return pitch_pre_plain(ac, hl, bi, sample_rate, fmin, fmax)
    if ac.dim() != 2 or hl.shape != (ac.shape[-1],) or not 0 <= bi <= ac.shape[-1]:
        raise ValueError(
            f"pitch_pre: ac (B, n), hl (n,), 0 <= bi <= n; got {tuple(ac.shape)}, {tuple(hl.shape)}, bi={bi}"
        )
    if hl.dtype != ac.dtype:
        raise TypeError(f"pitch_pre: ac and hl share a dtype, got {ac.dtype} and {hl.dtype}")
    B, n = ac.shape
    ac, hl = ac.contiguous(), hl.contiguous()
    self_lag = torch.empty((B, 2 * n), dtype=ac.dtype, device=ac.device)
    freq = torch.empty((B, bi), dtype=ac.dtype, device=ac.device)
    cand = torch.empty((B, bi), dtype=torch.bool, device=ac.device)
    kernels.launch("vt_pitch_pre", ac.dtype, ac, hl, self_lag, freq, cand, B, n, bi,
                   float(sample_rate), float(fmin), float(fmax))
    pitch_pre.launches += 1
    return self_lag, freq, cand


pitch_pre.launches = 0
