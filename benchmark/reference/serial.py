"""The stages of the analysis that carry state from frame to frame, plain.

- The McCandless formant tracker: `stages.track_step` over the frames one
  at a time (`track_serial`), or, to judge a tracked output, over every
  chosen frame at once from that output's own previous frame (`track_from`).
- Boersma (1993) section 4's Viterbi pitch path with Praat's path costs:
  the local scores (`path_inputs`) and the dynamic programme with its
  backtrace (`viterbi`), in NumPy float64, ties to the first winner.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.stages import NSLOTS, track_step


def track_serial(res_f, res_b, est_f, est_b):
    """Track one recording's (F, R) resonances from the (L,) seed
    estimates, a frame at a time: the per-frame estimates, (F, L) x 2, as
    NumPy float64. The same step as `stages.track_step`, on Python floats
    (a frame's step is a few hundred scalar operations; tensors would pay
    a launch for each)."""
    ef, eb = [float(v) for v in est_f], [float(v) for v in est_b]
    out_f, out_b = [], []
    for rf, rb in zip(np.asarray(res_f, np.float64).tolist(), np.asarray(res_b, np.float64).tolist()):
        ef, eb = _step(ef, eb, rf, rb)
        out_f.append(ef)
        out_b.append(eb)
    return np.asarray(out_f).reshape(-1, len(est_f)), np.asarray(out_b).reshape(-1, len(est_f))


def _step(ef, eb, rf, rb):
    L, R, ns = len(ef), len(rf), min(len(ef), NSLOTS)
    sf, sb, sv = [0.0] * NSLOTS, [0.0] * NSLOTS, [False] * NSLOTS
    for s in range(ns):  # the nearest resonance, the first on ties
        best = min(range(R), key=lambda j: abs(rf[j] - ef[s]))
        sf[s], sb[s], sv[s] = rf[best], rb[best], True
    w, unassigned = 0, False
    for r in range(1, NSLOTS):
        same = sv[r] and sf[r] == sf[w] and sb[r] == sb[w]
        closer = abs(sf[r] - ef[min(r, L - 1)]) < abs(sf[r] - ef[min(w, L - 1)])
        keep_r = (same and closer) or (not same and sv[r])
        if same:
            sv[w if closer else r] = False
        unassigned = unassigned or same
        if keep_r:
            w = r
    for j in range(min(R, NSLOTS)):
        pf, pb = rf[j], rb[j]
        if not unassigned or any(sv[s] and sf[s] == pf and sb[s] == pb for s in range(NSLOTS)):
            continue
        if not sv[j]:
            sf[j], sb[j], sv[j] = pf, pb, True
            continue
        for k in (j - 1, j + 1):
            if 0 <= k < NSLOTS and not sv[k]:
                sf[k], sb[k], sv[k] = sf[j], sb[j], sv[j]
                sf[j], sb[j], sv[j] = pf, pb, True
                break
    order = sorted(range(NSLOTS), key=lambda s: sf[s] if sv[s] else -math.inf)
    win = [s for s in order if sv[s] and sf[s] > 0]
    return ([sf[win[k]] if k < len(win) else ef[k] for k in range(L)],
            [sb[win[k]] if k < len(win) else eb[k] for k in range(L)])


def track_from(res_f, res_b, est_f, est_b, prev_f, prev_b, frames):
    """One tracker step at each of `frames` (indices into a recording),
    (K, R) resonances of those frames, each from the recording's (F, L)
    estimates `prev_*` at the frame before (the seed at frame 0): what
    those frames' estimates should be, given their previous frames'."""
    pf = torch.cat([est_f[None], prev_f])[frames]
    pb = torch.cat([est_b[None], prev_b])[frames]
    return track_step(pf, pb, res_f, res_b)


def intensity(local_peak: np.ndarray) -> np.ndarray:
    """Each frame's peak over the recording's peak (the last axis)."""
    return local_peak / np.maximum(local_peak.max(axis=-1, keepdims=True), 1e-30)


def path_inputs(freq, strength, valid, intensity_, path: dict):
    """(local scores, transition frequencies, voiced) of (..., F, C)
    candidates (Boersma 1993 eq. 23-24; the ratio before log2)."""
    voiced = freq > 0.0
    fs = np.where(voiced, freq, 1.0)
    s_voiced = strength - path["octave_cost"] * np.log2(path["ceiling"] / fs)
    vt = path["voicing_threshold"]
    s_unvoiced = vt + np.maximum(2.0 - intensity_[..., None] / (path["silence_threshold"] / (1.0 + vt)), 0.0)
    local = np.where(voiced, s_voiced, s_unvoiced)
    return np.where(valid, local, -np.inf), fs, voiced


def viterbi(local, fs, voiced, path: dict, rnd=None) -> np.ndarray:
    """The maximum-score path through (B, F, C) candidates: (B, F) indices.
    `rnd`, where given, rounds the running scores after each step."""
    B, F, C = local.shape
    ojc, vuc = path["octave_jump_cost"], path["voiced_unvoiced_cost"]
    score = local[:, 0].copy()
    bp = np.zeros((B, F, C), dtype=np.int64)
    rows = np.arange(B)[:, None]
    for t in range(1, F):
        vp, vc = voiced[:, t - 1, :, None], voiced[:, t, None, :]
        jump = np.abs(np.log2(fs[:, t - 1, :, None] / fs[:, t, None, :]))
        cost = np.where(vp & vc, ojc * jump, np.where(vp ^ vc, vuc, 0.0))
        cand = score[:, :, None] - cost
        bp[:, t] = np.argmax(cand, axis=1)
        score = local[:, t] + cand[rows, bp[:, t], np.arange(C)[None, :]]
        if rnd is not None:
            score = rnd(score)
    out = np.empty((B, F), dtype=np.int64)
    c = np.argmax(score, axis=-1)
    out[:, F - 1] = c
    for t in range(F - 1, 0, -1):
        c = bp[np.arange(B), t, c]
        out[:, t - 1] = c
    return out
