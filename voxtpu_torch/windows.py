"""Window tables: Hann and its analytic autocorrelation (Boersma 1993).

The reference takes windows from the external `sample` crate
(``sample::window::Hanning``) plus its own `HanningLag`
(`vox_box src/periodic.rs:236-252`). Phase convention is `i / n`
(periodic window), matching the explicit windowing loop in
`vox_box src/lib.rs:66-70`.

These are tiny host-side constant tables computed once in float64 numpy
(the same formulas as voxtpu.windows) and moved to the frames' device and
dtype by the callers.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["hann", "hanning_lag"]


@functools.lru_cache(maxsize=64)
def _hann_cached(n: int) -> np.ndarray:
    phase = np.arange(n, dtype=np.float64) / n
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * phase)


@functools.lru_cache(maxsize=64)
def _hanning_lag_cached(n: int) -> np.ndarray:
    # HanningLag::at_phase (periodic.rs:239-247):
    #   v = 2*pi*phase
    #   (1 - phase) * (2/3 + 1/3*cos(v)) + sin(v) / (2*pi)
    phase = np.arange(n, dtype=np.float64) / n
    v = 2.0 * np.pi * phase
    return (1.0 - phase) * (2.0 / 3.0 + np.cos(v) / 3.0) + np.sin(v) / (2.0 * np.pi)


def hann(n: int) -> np.ndarray:
    """Periodic Hann window of length `n`: 0.5 - 0.5*cos(2*pi*i/n)."""
    return _hann_cached(int(n)).copy()


def hanning_lag(n: int) -> np.ndarray:
    """Analytic autocorrelation of the periodic Hann window (Boersma eq. 1993).

    Reference: HanningLag (periodic.rs:236-248), used to divide the frame's
    autocorrelation in `Pitched::pitch` (periodic.rs:400, 406-408).
    """
    return _hanning_lag_cached(int(n)).copy()
