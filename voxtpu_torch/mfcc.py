"""MFCC: mel filterbank energies + DCT, as two matmuls around one rFFT.

Port of voxtpu.mfcc (reference: vox_box src/spectrum.rs:371-441), with the
same reference quirks in exact mode (the default): the rising filter slope
weights power and the falling slope magnitude, both slopes ascend i/width,
the log is clamped as max(log10(e), 1e-10), mel is the 1125/700 ln variant,
bins are floor((len+1) * hz / sr), and the DCT is the unnormalized DCT-II
with factor 2. exact=False gives a corrected textbook filterbank.

The filterbank and DCT matmuls must run in true float32 on the card: TF32
keeps about three decimal digits and costs ~1e-2 in the cepstra, the GPU
analog of voxtpu's HIGHEST-precision lesson (voxtpu/mfcc.py:158-162).
`_pin_fp32_matmul` turns TF32 off for cuBLAS and cuDNN before each product.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["hz_to_mel", "mel_to_hz", "dct", "dct_matrix", "mel_banks", "mfcc"]


def hz_to_mel(hz):
    """1125 * ln(1 + hz/700) (spectrum.rs:375-377)."""
    return 1125.0 * np.log1p(np.asarray(hz) / 700.0)


def mel_to_hz(mel):
    """700 * (exp(mel/1125) - 1) (spectrum.rs:379-381)."""
    return 700.0 * (np.exp(np.asarray(mel) / 1125.0) - 1.0)


def _pin_fp32_matmul() -> None:
    """Float32 products in full float32, never TF32 (see module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=32)
def dct_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-II matrix: out[k] = 2 * sum_n s[n] cos(pi k (2n+1) / 2N)."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))


def dct(x: torch.Tensor) -> torch.Tensor:
    """DCT-II along the last axis (matmul form, true fp32 on the card)."""
    _pin_fp32_matmul()
    mat = torch.as_tensor(dct_matrix(x.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.matmul(x, mat.T)


@functools.lru_cache(maxsize=32)
def mel_banks(
    frame_len: int,
    num_coeffs: int,
    freq_lo: float,
    freq_hi: float,
    sample_rate: float,
    exact: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Triangular filterbank weight matrices (w_power, w_magnitude), each
    (num_coeffs, frame_len): filter f's energy is power @ w_power[f] +
    magnitude @ w_mag[f] (spectrum.rs:411-433)."""
    mel_lo = float(hz_to_mel(freq_lo))
    mel_hi = float(hz_to_mel(freq_hi))
    mel_range = mel_hi - mel_lo
    points = [(i / num_coeffs) * mel_range + mel_lo for i in range(num_coeffs + 2)]
    bins = [int(math.floor((frame_len + 1) * float(mel_to_hz(p)) / sample_rate)) for p in points]

    w_pow = np.zeros((num_coeffs, frame_len))
    w_mag = np.zeros((num_coeffs, frame_len))
    for f in range(num_coeffs):
        b0, b1, b2 = bins[f], bins[f + 1], bins[f + 2]
        up = b1 - b0
        for i, b in enumerate(range(b0, b1)):
            if b < frame_len:
                w_pow[f, b] += i / up
        down = b2 - b1
        for i, b in enumerate(range(b1, b2)):
            if b >= frame_len:
                continue
            if exact:
                w_mag[f, b] += i / down
            else:
                w_pow[f, b] += 1.0 - (i / down)
    return w_pow, w_mag


@functools.lru_cache(maxsize=32)
def _folded_banks(n, num_coeffs, freq_lo, freq_hi, sample_rate, exact):
    """mel_banks folded onto the rfft half spectrum: the full FFT of a real
    frame is conjugate-symmetric, so w_half[k] = w[k] + w[n-k]. Returns
    (wp, wm), each (n//2+1, num_coeffs) float64."""
    w_pow, w_mag = mel_banks(n, num_coeffs, freq_lo, freq_hi, sample_rate, exact)
    half = n // 2 + 1
    fold = np.zeros((n, half))
    for k in range(n):
        fold[k, k if k <= n // 2 else n - k] = 1.0
    return (w_pow @ fold).T, (w_mag @ fold).T


def mfcc(
    x: torch.Tensor,
    num_coeffs: int,
    freq_bounds: tuple[float, float],
    sample_rate: float,
    exact: bool = True,
    half_power: torch.Tensor | None = None,
) -> torch.Tensor:
    """MFCC of (already windowed) frames (..., n) -> (..., num_coeffs).

    half_power: optional precomputed |rfft(x)|^2 of shape (..., n//2+1).
    """
    n = x.shape[-1]
    dt = x.dtype
    wp_np, wm_np = _folded_banks(n, num_coeffs, float(freq_bounds[0]),
                                 float(freq_bounds[1]), float(sample_rate), exact)
    wp = torch.as_tensor(wp_np, dtype=dt, device=x.device)
    wm = torch.as_tensor(wm_np, dtype=dt, device=x.device)

    if half_power is None:
        spec = torch.fft.rfft(x, dim=-1)
        half_pow = (spec.real.square() + spec.imag.square()).to(dt)
    else:
        half_pow = half_power
    half_mag = torch.sqrt(half_pow)
    _pin_fp32_matmul()
    energies = torch.matmul(half_pow, wp) + torch.matmul(half_mag, wm)

    if exact:
        # log10(e).max(1e-10): -inf (e == 0) and small energies clamp to 1e-10
        # (spectrum.rs:434).
        log_e = torch.clamp(torch.log10(torch.clamp(energies, min=0.0)), min=1e-10)
    else:
        log_e = torch.log10(torch.clamp(energies, min=1e-30))
    return dct(log_e)
