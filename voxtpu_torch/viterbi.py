"""Pitch path search: the Viterbi pass the reference stubbed out.

Port of voxtpu.viterbi. The reference's `PitchExtractor` carries path-cost
fields but returns `candidates[frame][0]` (periodic.rs:320-354); this module
is Boersma (1993) §4's dynamic path search. The local scores are computed
here in PyTorch; the DP and its backtrace run in kernel F
(voxtpu_torch.ops.viterbi) on the card, and as its plain Python loop on the
CPU. `pitch_path_host` takes and returns NumPy arrays, through the plain DP.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from voxtpu_torch.device import as_input
from voxtpu_torch.ops.viterbi import viterbi_path
from voxtpu_torch.pitch import pitch_frames

__all__ = ["PathConfig", "path_inputs", "pitch_path", "pitch_path_host", "pitch_track", "take_best"]


@dataclass(frozen=True)
class PathConfig:
    """Praat-style path costs (Boersma 1993 defaults)."""

    silence_threshold: float = 0.03
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14
    ceiling: float = 600.0


def take_best(freq: torch.Tensor, strength: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stub-compatible mode: candidates[frame][0] (periodic.rs:340-353)."""
    return freq[..., 0], strength[..., 0]


def path_inputs(
    freq: torch.Tensor,
    strength: torch.Tensor,
    valid: torch.Tensor,
    config: PathConfig = PathConfig(),
    local_intensity: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DP's inputs (local scores, transition frequencies, voiced mask)
    from the candidates, as `pitch_path` hands them to the kernel."""
    voiced = freq > 0.0
    fs = torch.where(voiced, freq, 1.0)

    # Local per-candidate scores (Boersma 1993 eq. 23-24), in voxtpu's op
    # order: the ratio before log2.
    s_voiced = strength - config.octave_cost * torch.log2(config.ceiling / fs)
    if local_intensity is not None:
        li = torch.as_tensor(local_intensity, dtype=freq.dtype, device=freq.device)[..., None]
        s_unvoiced = config.voicing_threshold + torch.clamp(
            2.0 - li / (config.silence_threshold / (1.0 + config.voicing_threshold)), min=0.0
        )
    else:
        s_unvoiced = strength
    local = torch.where(voiced, s_voiced, s_unvoiced)
    return torch.where(valid, local, -math.inf), fs, voiced


def pitch_path(
    freq: torch.Tensor,
    strength: torch.Tensor,
    valid: torch.Tensor,
    config: PathConfig = PathConfig(),
    local_intensity: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi path through per-frame pitch candidates.

    freq/strength/valid: (F, C) candidates, or (B, F, C) for B recordings
    searched in one kernel launch (freq == 0 marks the unvoiced candidate).
    local_intensity: optional (F,) or (B, F) frame intensity relative to the
    recording's peak; it drives Praat's silence-aware unvoiced strength.
    Returns (f0, strength) along the maximum-score path, (F,) or (B, F).
    """
    local, fs, voiced = path_inputs(freq, strength, valid, config, local_intensity)
    path = viterbi_path(local, fs, voiced, config.octave_jump_cost, config.voiced_unvoiced_cost)
    idx = path.long()[..., None]
    return torch.gather(freq, -1, idx)[..., 0], torch.gather(strength, -1, idx)[..., 0]


def pitch_path_host(
    freq,
    strength,
    valid,
    config: PathConfig = PathConfig(),
    local_intensity=None,
):
    """`pitch_path` for one recording's host arrays (F, C), run on CPU
    tensors (the plain DP). Returns NumPy (f0, strength), (F,) each."""
    f0, s0 = pitch_path(
        torch.as_tensor(np.asarray(freq)), torch.as_tensor(np.asarray(strength)),
        torch.as_tensor(np.asarray(valid)), config,
        None if local_intensity is None else torch.as_tensor(np.asarray(local_intensity)),
    )
    return f0.numpy(), s0.numpy()


def pitch_track(
    frames,
    sample_rate: float,
    threshold: float = 0.2,
    fmin: float = 60.0,
    fmax: float = 600.0,
    max_candidates: int = 32,
    config: PathConfig | None = None,
    use_path: bool = True,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidates + path search in one call over pre-windowed (F, n) frames.
    Runs on the card unless `frames` is a tensor elsewhere or device="cpu"
    (voxtpu_torch.device.as_input)."""
    frames = as_input(frames, device)
    freq, strength, valid = pitch_frames(
        frames, sample_rate, threshold=threshold, fmin=fmin, fmax=fmax,
        max_candidates=max_candidates,
    )
    if not use_path:
        return take_best(freq, strength)
    return pitch_path(freq, strength, valid, config or PathConfig(ceiling=fmax))
