"""Boersma (1993) autocorrelation pitch detection, batched over frames.

Port of voxtpu.pitch (reference: `Pitched::pitch`, periodic.rs:377-456):
  1. quirk-exact FFT autocorrelation -> normalize by max -> divide by the
     analytic Hann lag window -> zero non-finite rows -> zero-pad to 2n;
  2. local maxima over the first floor(n/2) lags (3-point compare);
  3. parabolic frequency per maximum, band filter (1-3 after the
     autocorrelation: kernel G, voxtpu_torch.ops.pitch_pre);
  4. the first `max_candidates` band-passed maxima in lag order;
  5. Brent over the depth-1200 windowed sinc (kernel A, voxtpu_torch.ops.
     refine, through sinc.improve_extremum_sinc); the reference's dead
     depth-30 strength eval is skipped as in voxtpu;
  6. the unvoiced candidate (0, threshold) appended, then a stable sort by
     strength descending.

`refine="parabolic"` keeps the parabolic vertex and takes the depth-30 sinc
strength there through kernel A's evaluation-only mode (iters=0), as voxtpu's
TPU path does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from voxtpu_torch.autocorr import autocorrelate
from voxtpu_torch.device import constant
from voxtpu_torch.ops.pitch_pre import pitch_pre
from voxtpu_torch.ops.refine import refine as refine_op
from voxtpu_torch.sinc import _max_effective_depth, improve_extremum_sinc
from voxtpu_torch.windows import hanning_lag

__all__ = ["LagCandidates", "lag_candidates", "pitch_frames", "best_pitch"]

INTERPOLATION_DEPTH = 0.5  # periodic.rs:413
STRENGTH_SINC_DEPTH = 30  # periodic.rs:433
REFINE_SINC_DEPTH = 1200  # periodic.rs:444


@dataclass(frozen=True)
class LagCandidates:
    """Pitch pre-stage output: kernel A's inputs."""

    self_lag: torch.Tensor  # (B, 2n) normalized, lag-windowed, zero-padded autocorrelation
    freq: torch.Tensor  # (B, C) parabolic frequencies of the candidates (0 on dead lanes)
    valid: torch.Tensor  # (B, C) lanes holding a band-passed maximum
    pos: torch.Tensor  # (B, C) Brent start positions (dead lanes: bi + 0.5)
    bi: int  # brent_ixmax = floor(n / 2)
    offset: int  # -bi - 1
    nx: int  # 2 bi + 1
    max_x: float  # bound on live positions: sample_rate / fmin - offset


def lag_candidates(
    frames: torch.Tensor, sample_rate: float, fmin: float, fmax: float, max_candidates: int,
    precomputed_ac: torch.Tensor | None = None,
) -> LagCandidates:
    """Steps 1-4 of pitch_frames over (B, n) windowed frames: the lag
    buffer and the first min(max_candidates, floor(n/2) - 2) band-passed
    maxima in lag order."""
    n = frames.shape[-1]
    dt, dev = frames.dtype, frames.device
    bi = int(math.floor(INTERPOLATION_DEPTH * n))  # brent_ixmax
    C = min(max_candidates, bi - 2)  # the maxima axis has bi - 2 centers

    # --- steps 1-3 (periodic.rs:400-439): normalize, lag window, NaN-row
    # zeroing, 2n pad, 3-point maxima, parabolic frequency, band filter;
    # kernel G on the card.
    ac = autocorrelate(frames, n) if precomputed_ac is None else precomputed_ac
    hl = constant(hanning_lag, n, dtype=dt, device=dev)
    self_lag, freq_l, cand_l = pitch_pre(ac, hl, bi, sample_rate, fmin, fmax)
    cand, freq = cand_l[:, 1 : bi - 1], freq_l[:, 1 : bi - 1]  # centers 1..bi-2
    ix = torch.arange(1, bi - 1, device=dev)

    # --- the first C candidates in lag order (reference push order). Valid
    # keys are distinct lags, so the smallest-C selection is exact; the order
    # among non-candidate lanes does not matter (they are masked).
    keys = torch.where(cand, ix[None, :], bi)
    kvals, order = torch.topk(keys, C, dim=-1, largest=False, sorted=True)
    valid = kvals < bi
    freq_c = torch.gather(freq, 1, order)

    offset = -bi - 1
    pos = sample_rate / freq_c - offset
    # Dead lanes get an in-range NON-integer fill so they never take the
    # integer-snap branch (voxtpu.pitch); their outputs are masked later.
    pos = torch.where(valid, pos, float(bi) + 0.5)
    return LagCandidates(
        self_lag=self_lag, freq=freq_c, valid=valid, pos=pos, bi=bi, offset=offset,
        nx=bi - offset, max_x=sample_rate / fmin - offset,
    )


def pitch_frames(
    frames: torch.Tensor,
    sample_rate: float,
    threshold: float = 0.2,
    fmin: float = 50.0,
    fmax: float = 600.0,
    max_candidates: int = 32,
    precomputed_ac: torch.Tensor | None = None,
    refine_depth: int | None = None,
    refine: str = "sinc",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pitch candidates for (B, n) already windowed frames.

    The reference ignores its local_peak/global_peak arguments
    (periodic.rs:357, 396), so they are not taken here. Returns (freq,
    strength, valid), each (B, max_candidates + 1), sorted by strength
    descending; unused lanes have valid=False, freq 0 and strength 0 and
    sort last.
    """
    if refine not in ("sinc", "parabolic"):
        raise ValueError(f"unknown refine mode {refine!r}")
    if frames.dim() == 1:
        frames = frames[None]
    B = frames.shape[0]
    dt, dev = frames.dtype, frames.device
    lc = lag_candidates(frames, sample_rate, fmin, fmax, max_candidates, precomputed_ac)
    self_lag, cand_c, pos = lc.self_lag, lc.valid, lc.pos
    bi, offset, nx, max_x = lc.bi, lc.offset, lc.nx, lc.max_x
    C_req, C = max_candidates, cand_c.shape[1]
    freq_c = lc.freq
    depth = REFINE_SINC_DEPTH if refine_depth is None else int(refine_depth)

    if refine == "parabolic":
        # Depth-30 sinc strength at the parabolic vertex (periodic.rs:429-435),
        # with interpolate_sinc's outer edge returns (periodic.rs:39-40).
        t30 = _max_effective_depth(offset, nx, STRENGTH_SINC_DEPTH, max_x) + 1
        _, strn = refine_op(self_lag, pos, cand_c, offset, STRENGTH_SINC_DEPTH, t30 - 1, iters=0)
        strn = torch.where(pos > nx, self_lag[:, bi - 1 : bi], strn)
        strn = torch.where(pos < 0.0, self_lag[:, :1], strn)
        strength_r = torch.where(strn > 1.0, 1.0 / strn, strn)
        freq_r = freq_c
    else:
        # Brent over depth-1200 sinc (periodic.rs:440-450).
        xmid, ymid = improve_extremum_sinc(
            self_lag, offset, nx, pos, depth, max_x=max_x + 1.0, lane_mask=cand_c,
        )
        xmid = xmid + offset
        strength_r = torch.where(ymid > 1.0, 1.0 / ymid, ymid)
        freq_r = sample_rate / xmid

    # --- append the unvoiced candidate + stable sort by strength desc
    # (periodic.rs:452-453)
    freq_all = torch.cat([torch.where(cand_c, freq_r, 0.0), torch.zeros((B, 1), dtype=dt, device=dev)], dim=-1)
    strength_all = torch.cat(
        [torch.where(cand_c, strength_r, -math.inf), torch.full((B, 1), threshold, dtype=dt, device=dev)],
        dim=-1,
    )
    valid_all = torch.cat([cand_c, torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=-1)
    order = torch.sort(-strength_all, dim=-1, stable=True).indices
    freq_s = torch.gather(freq_all, 1, order)
    strength_s = torch.gather(strength_all, 1, order)
    valid_s = torch.gather(valid_all, 1, order)
    strength_s = torch.where(valid_s, strength_s, 0.0)
    if C_req > C:
        pad = (0, C_req - C)
        freq_s = torch.nn.functional.pad(freq_s, pad)
        strength_s = torch.nn.functional.pad(strength_s, pad)
        valid_s = torch.nn.functional.pad(valid_s, pad)
    return freq_s, strength_s, valid_s


def best_pitch(freq: torch.Tensor, strength: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The strongest candidate per frame (periodic.rs:340-353's stub path)."""
    return freq[..., 0], strength[..., 0]
