"""The per-file analysis pipeline: pitch + formants + MFCC + RMS.

Port of voxtpu.pipeline's one-recording path. `analyze(samples, config)`
frames a 1-D signal and `analyze_frames` computes every feature over the
(F, n) frames: pitch and MFCC on Hann-windowed frames, formants on the raw
frames (find_formants windows internally), RMS on the raw frames. Work runs
on the device of the input tensor, in its dtype: float64 is the parity mode,
float32 the working type on the card. Four CUDA kernels carry the card path
(refine, burg, find_roots, formant_scan; see voxtpu_torch.ops).

`config_from_jax` reads a `voxtpu.pipeline.AnalysisConfig` (by attribute,
without importing voxtpu) into this module's dataclasses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from voxtpu_torch import errors, waves
from voxtpu_torch.formants import MALE_FORMANT_ESTIMATES, find_formants, formant_candidates
from voxtpu_torch.frame import frame_signal
from voxtpu_torch.mfcc import mfcc
from voxtpu_torch.pitch import pitch_frames
from voxtpu_torch.windows import hann

__all__ = [
    "PitchConfig", "FormantConfig", "MfccConfig", "AnalysisConfig", "CLI_DEFAULT_44K",
    "config_from_jax", "f0_outputs", "f0_outputs_host", "analyze_frames", "analyze",
]


@dataclass(frozen=True)
class PitchConfig:
    enabled: bool = True
    threshold: float = 0.2
    fmin: float = 60.0
    fmax: float = 600.0
    max_candidates: int = 32
    #: the Viterbi path search is not ported yet; True raises
    viterbi: bool = False
    #: "sinc" (Brent over windowed sinc, periodic.rs:440-450) or "parabolic"
    refine: str = "sinc"
    #: cap on the refine pass's sinc depth; None = the reference's 1200
    refine_depth: int | None = None


@dataclass(frozen=True)
class FormantConfig:
    enabled: bool = True
    n_coeffs: int = 13
    resample_ratio: float = 1.0
    estimates: tuple = MALE_FORMANT_ESTIMATES
    estimate_bandwidth: float = 1.0
    #: compensated-Newton root polish in float32 (no-op in float64)
    polish: bool = True


@dataclass(frozen=True)
class MfccConfig:
    enabled: bool = True
    num_coeffs: int = 13
    freq_lo: float = 100.0
    freq_hi: float = 5000.0
    preemphasis_factor: float | None = None
    exact: bool = True


@dataclass(frozen=True)
class AnalysisConfig:
    sample_rate: float = 11025.0
    frame_len: int = 1024
    hop: int = 512
    pitch: PitchConfig = field(default_factory=PitchConfig)
    formant: FormantConfig = field(default_factory=FormantConfig)
    mfcc: MfccConfig = field(default_factory=MfccConfig)


#: `voxtpu.cli.build_analysis_config(44100.0)` with its defaults, the
#: configuration `python -m voxtpu analyze|corpus` and `serve` run on 44.1 kHz
#: audio: 50 ms frames (2205 samples), 10 ms hop (441), every feature on.
CLI_DEFAULT_44K = AnalysisConfig(
    sample_rate=44100.0,
    frame_len=int(math.ceil(44100.0 * 50.0 / 1000.0)),
    hop=int(math.ceil(44100.0 * 10.0 / 1000.0)),
    pitch=PitchConfig(threshold=0.2, fmin=60.0, fmax=600.0, refine="sinc", refine_depth=None),
    formant=FormantConfig(n_coeffs=13),
    mfcc=MfccConfig(num_coeffs=13),
)


def config_from_jax(cfg) -> AnalysisConfig:
    """This module's AnalysisConfig with the values of a
    `voxtpu.pipeline.AnalysisConfig` (read by attribute)."""
    p, f, m = cfg.pitch, cfg.formant, cfg.mfcc
    return AnalysisConfig(
        sample_rate=float(cfg.sample_rate),
        frame_len=int(cfg.frame_len),
        hop=int(cfg.hop),
        pitch=PitchConfig(
            enabled=bool(p.enabled), threshold=float(p.threshold), fmin=float(p.fmin),
            fmax=float(p.fmax), max_candidates=int(p.max_candidates), viterbi=bool(p.viterbi),
            refine=str(p.refine), refine_depth=None if p.refine_depth is None else int(p.refine_depth),
        ),
        formant=FormantConfig(
            enabled=bool(f.enabled), n_coeffs=int(f.n_coeffs), resample_ratio=float(f.resample_ratio),
            estimates=tuple(float(e) for e in f.estimates),
            estimate_bandwidth=float(f.estimate_bandwidth), polish=bool(f.polish),
        ),
        mfcc=MfccConfig(
            enabled=bool(m.enabled), num_coeffs=int(m.num_coeffs), freq_lo=float(m.freq_lo),
            freq_hi=float(m.freq_hi),
            preemphasis_factor=None if m.preemphasis_factor is None else float(m.preemphasis_factor),
            exact=bool(m.exact),
        ),
    )


def f0_outputs(f0: torch.Tensor, strength: torch.Tensor) -> dict:
    """f0 / f0_strength / hnr_db from a chosen pitch track. HNR is
    10 log10(r / (1 - r)) of the strength r (Boersma 1993 eq. 4), -inf where
    f0 == 0 (unvoiced)."""
    s_best = torch.clamp(strength, 1e-6, 1.0 - 1e-6)
    hnr = 10.0 * torch.log10(s_best / (1.0 - s_best))
    return {
        "f0": f0,
        "f0_strength": strength,
        "hnr_db": torch.where(f0 > 0, hnr, -math.inf),
    }


def f0_outputs_host(f0: np.ndarray, strength: np.ndarray) -> dict:
    """NumPy twin of `f0_outputs` for host arrays."""
    s_best = np.clip(strength, 1e-6, 1.0 - 1e-6)
    hnr = (10.0 * np.log10(s_best / (1.0 - s_best))).astype(strength.dtype)
    return {
        "f0": f0,
        "f0_strength": strength,
        "hnr_db": np.where(f0 > 0, hnr, np.asarray(-np.inf, dtype=hnr.dtype)),
    }


def analyze_frames(
    frames: torch.Tensor,
    config: AnalysisConfig,
    formant_estimates: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_formant_candidates: bool = False,
) -> dict:
    """Analyze rectangular frames (F, n): returns the feature dict.

    formant_estimates: optional (freqs, bws) overriding the config's starting
    estimates (the carry of a chunked analysis).
    return_formant_candidates: skip the tracker and return the per-frame
    resonance buffers ("resonance_freqs"/"resonance_bws") instead of
    "formant_freqs"/"formant_bws".
    """
    if config.pitch.enabled and config.pitch.viterbi:
        raise NotImplementedError("PitchConfig.viterbi is not yet ported to voxtpu_torch")
    sr = config.sample_rate
    n = frames.shape[-1]
    dt, dev = frames.dtype, frames.device
    out: dict = {}

    window = torch.as_tensor(hann(n), dtype=dt, device=dev)
    windowed = frames * window

    out["rms"] = waves.rms(frames)
    input_status = torch.where(
        torch.all(torch.isfinite(frames), dim=-1), 0, errors.NONFINITE_INPUT
    ).to(torch.int32)

    # Power-of-two frames with pitch and MFCC on (and no preemphasis) share
    # one FFT: the 2n-point power spectrum's even bins are the n-point ones.
    share_fft = (
        config.pitch.enabled
        and config.mfcc.enabled
        and config.mfcc.preemphasis_factor is None
        and (n & (n - 1)) == 0
    )
    shared_ac = shared_half_power = None
    if share_fft:
        from voxtpu_torch.autocorr import power_and_autocorrelate

        shared_half_power, shared_ac = power_and_autocorrelate(windowed, n)

    if config.pitch.enabled:
        p = config.pitch
        freq, strength, valid = pitch_frames(
            windowed, sr, threshold=p.threshold, fmin=p.fmin, fmax=p.fmax,
            max_candidates=p.max_candidates, precomputed_ac=shared_ac,
            refine=p.refine, refine_depth=p.refine_depth,
        )
        out["pitch_candidates_freq"] = freq
        out["pitch_candidates_strength"] = strength
        out["pitch_candidates_valid"] = valid
        out.update(f0_outputs(freq[..., 0], strength[..., 0]))

    if config.formant.enabled:
        f = config.formant
        if return_formant_candidates:
            rfreq, rbw, status = formant_candidates(
                frames, sr, f.n_coeffs, resample_ratio=f.resample_ratio, polish=f.polish,
            )
            out["resonance_freqs"] = rfreq
            out["resonance_bws"] = rbw
        else:
            est_f, est_b = formant_estimates if formant_estimates is not None else (f.estimates, None)
            freqs, bws, status = find_formants(
                frames, sr, f.n_coeffs, resample_ratio=f.resample_ratio,
                estimates=est_f, estimate_bandwidth=f.estimate_bandwidth,
                estimate_bws=est_b, polish=f.polish,
            )
            out["formant_freqs"] = freqs
            out["formant_bws"] = bws
        out["status"] = status | input_status
    else:
        out["status"] = input_status

    if config.mfcc.enabled:
        m = config.mfcc
        x = frames
        if m.preemphasis_factor is not None:
            x = waves.preemphasis(x, m.preemphasis_factor)
        out["mfcc"] = mfcc(
            x * window, m.num_coeffs, (m.freq_lo, m.freq_hi), sr, exact=m.exact,
            half_power=shared_half_power,
        )
    return out


def analyze(samples, config: AnalysisConfig) -> dict:
    """Frame a 1-D signal (tensor or array; a tensor keeps its device and
    dtype) and analyze it."""
    return analyze_frames(frame_signal(samples, config.frame_len, config.hop), config)
