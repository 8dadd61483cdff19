"""Reference-shaped compatibility surface for migrating vox_box.rs callers.

Port of voxtpu.compat: thin adapters over the batched pipeline, shaped like
the reference's public API (SURVEY.md API census):

- `find_formants_real_work_size` / `find_formants_complex_work_size`
  (lib.rs:30-36): workspaces are PyTorch's to manage; kept as no-ops that
  return the reference's sizes.
- `FormantExtractor` (spectrum.rs:336-369): iterator over per-frame formant
  estimates; runs the tracker (kernel D on the card) once and iterates the
  result.
- `PitchExtractor` (periodic.rs:320-354): the reference's stub returns
  candidates[frame][0]; `use_path=True` runs the Viterbi path search.
- `pitch` (periodic.rs:356-358, the 6-argument form) and `pitch_praat` (the
  8-argument Praat form the stale callers reveal, benches/periodic.rs:39).

Every shim takes `device=None` and places its input with
`voxtpu_torch.device.as_input`: on the card unless device="cpu" (or a CPU
tensor). Per-frame calls are a migration aid, not a hot loop: one
`voxtpu_torch.pitch.pitch_frames` call over the (F, n) frames does every
frame at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxtpu_torch.device import as_input
from voxtpu_torch.formants import formant_tracker
from voxtpu_torch.pitch import pitch_frames
from voxtpu_torch.viterbi import PathConfig, pitch_path

__all__ = [
    "find_formants_real_work_size",
    "find_formants_complex_work_size",
    "Pitch",
    "Resonance",
    "FormantExtractor",
    "PitchExtractor",
    "pitch",
    "pitch_praat",
]


def find_formants_real_work_size(buf_len: int, n_coeffs: int) -> int:
    """lib.rs:30-32; returned for API parity only."""
    return buf_len * 2 + n_coeffs * 23 + 2


def find_formants_complex_work_size(n_coeffs: int) -> int:
    """lib.rs:34-36; returned for API parity only."""
    return n_coeffs * 7 + 4


@dataclass
class Pitch:
    frequency: float
    strength: float


@dataclass
class Resonance:
    frequency: float
    bandwidth: float


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class FormantExtractor:
    """Iterator over tracked formants (spectrum.rs:336-369 semantics).

    Takes per-frame resonance lists; the tracker runs once on construction
    (float64), and iteration yields per-frame `[Resonance]` snapshots."""

    def __init__(self, num_formants: int, resonances, starting_estimates, device=None):
        self.num_formants = num_formants
        frames = list(resonances)
        if not frames:
            self._freqs = np.zeros((0, num_formants))
            self._bws = np.zeros((0, num_formants))
        else:
            R = max(len(f) for f in frames)
            rf = np.zeros((len(frames), R))
            rb = np.zeros((len(frames), R))
            for i, f in enumerate(frames):
                for j, r in enumerate(f):
                    rf[i, j], rb[i, j] = r.frequency, r.bandwidth
            rf_t, rb_t = as_input(rf, device), as_input(rb, device)
            ef = torch.as_tensor([e.frequency for e in starting_estimates], dtype=rf_t.dtype, device=rf_t.device)
            eb = torch.as_tensor([e.bandwidth for e in starting_estimates], dtype=rf_t.dtype, device=rf_t.device)
            freqs, bws = formant_tracker(rf_t, rb_t, ef, eb)
            self._freqs, self._bws = _host(freqs), _host(bws)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._freqs.shape[0]:
            raise StopIteration
        out = [Resonance(float(f), float(b)) for f, b in zip(self._freqs[self._i], self._bws[self._i])]
        self._i += 1
        return out


class PitchExtractor:
    """periodic.rs:320-354 semantics: `use_path=False` reproduces the stub
    (candidates[frame][0]); True runs the Viterbi search the reference left
    unimplemented."""

    def __init__(self, candidates, voiced_unvoiced_cost=0.14, voicing_threshold=0.45,
                 use_path: bool = False, device=None):
        frames = list(candidates)
        C = max((len(f) for f in frames), default=1)
        freq = np.zeros((len(frames), C))
        strength = np.full((len(frames), C), -np.inf)
        valid = np.zeros((len(frames), C), dtype=bool)
        for i, f in enumerate(frames):
            for j, p in enumerate(f):
                freq[i, j], strength[i, j] = p.frequency, p.strength
                valid[i, j] = True
        if not frames:
            self._f0 = np.zeros(0)
            self._s0 = np.zeros(0)
        elif use_path:
            cfg = PathConfig(voiced_unvoiced_cost=voiced_unvoiced_cost, voicing_threshold=voicing_threshold)
            f0, s0 = pitch_path(
                as_input(freq, device), as_input(np.where(valid, strength, -np.inf), device),
                as_input(valid, device), cfg,
            )
            self._f0, self._s0 = _host(f0), _host(s0)
        else:
            self._f0, self._s0 = freq[:, 0], strength[:, 0]
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._f0):
            raise StopIteration
        out = Pitch(float(self._f0[self._i]), float(self._s0[self._i]))
        self._i += 1
        return out


def pitch(frame, sample_rate, threshold, local_peak, global_peak, fmin, fmax,
          max_candidates: int = 32, device=None):
    """The reference's 6-argument `Pitched::pitch` (periodic.rs:356-358) for
    one pre-windowed frame: [Pitch] sorted by strength descending.
    local_peak and global_peak are ignored, as in the reference
    (periodic.rs:357, 396)."""
    x = as_input(frame, device)
    freq, strength, valid = pitch_frames(
        x[None, :], float(sample_rate), threshold=threshold, fmin=float(fmin), fmax=float(fmax),
        max_candidates=max_candidates,
    )
    f, s, v = _host(freq[0]), _host(strength[0]), _host(valid[0])
    return [Pitch(float(a), float(b)) for a, b, ok in zip(f, s, v) if ok]


def pitch_praat(frames, sample_rate, threshold=0.2, silence_threshold=0.03,
                voicing_threshold=0.45, octave_cost=0.01, octave_jump_cost=0.35,
                voiced_unvoiced_cost=0.14, fmin=60.0, fmax=600.0,
                max_candidates: int = 32, local_intensity=None, device=None):
    """The Praat-complete signature the reference's stale 8-argument callers
    imply (benches/periodic.rs:39, examples/formant_extraction/src/main.rs:76):
    candidates plus the Viterbi path search with the full cost set.

    frames: (F, n) pre-windowed frames. Returns NumPy (f0, strength), (F,)."""
    x = as_input(frames, device)
    freq, strength, valid = pitch_frames(
        x, float(sample_rate), threshold=threshold, fmin=float(fmin), fmax=float(fmax),
        max_candidates=max_candidates,
    )
    cfg = PathConfig(
        silence_threshold=silence_threshold, voicing_threshold=voicing_threshold,
        octave_cost=octave_cost, octave_jump_cost=octave_jump_cost,
        voiced_unvoiced_cost=voiced_unvoiced_cost, ceiling=float(fmax),
    )
    li = None if local_intensity is None else as_input(local_intensity, x.device)
    f0, s0 = pitch_path(freq, strength, valid, cfg, local_intensity=li)
    return _host(f0), _host(s0)
