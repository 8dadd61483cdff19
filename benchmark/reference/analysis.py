"""The plain reference over one block: every feature of every real frame of
each recording, from the same float32 samples that the program was given.

`analyze_block` computes, per recording of a block, its frames' RMS, input
status, pitch candidates, formant resonances and status, and MFCC, in
chunks of frames on `device` in `dtype`; then f0 (the strongest candidate,
or with the path search the Viterbi path over the block's padded frame
axis, as the corpus block runs it) and the tracked formants. `rnd` is
applied after each stage (identity for the reference, `tf32` for the
control). The tracker runs one of two ways: `follow`, the program's
tracked output, gives each frame's step its previous frame's estimates
(`serial.track_from`), so any sample of frames can be judged; without it
the tracker runs frame by frame (`serial.track_serial`), as the control
does in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import serial, stages

# Frames a chunk of the frame-local stages takes at once.
CHUNK_FRAMES = 32768


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit significand (round to
    nearest, ties to even); other dtypes and integers pass through."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    return max((n_samples - frame_len) // hop + 1, 0)


def _frame_features(frames, cfg: dict, rnd) -> dict:
    sr = cfg["sample_rate"]
    p, f, m = cfg["pitch"], cfg["formant"], cfg["mfcc"]
    frames = rnd(frames)
    windowed = rnd(frames * torch.as_tensor(stages.hann(frames.shape[-1]), dtype=frames.dtype,
                                            device=frames.device))
    freq, strength, valid = stages.pitch_candidates(windowed, sr, p["threshold"], p["fmin"], p["fmax"],
                                                    p["max_candidates"], rnd=rnd)
    rf, rb, status = stages.formant_candidates(frames, sr, f["n_coeffs"], polish_f32=f["polish"], rnd=rnd)
    status = status | torch.where(torch.all(torch.isfinite(frames), dim=-1), 0, stages.NONFINITE_INPUT).to(torch.int32)
    return {
        "rms": torch.sqrt(torch.mean(torch.square(frames), dim=-1)),
        "status": status,
        "pitch_candidates_freq": freq, "pitch_candidates_strength": strength, "pitch_candidates_valid": valid,
        "res_f": rf, "res_b": rb,
        "mfcc": stages.mfcc(windowed, m["num_coeffs"], m["freq_lo"], m["freq_hi"], sr, rnd=rnd),
    }


def f0_outputs(f0: np.ndarray, strength: np.ndarray) -> dict:
    s = np.clip(strength, 1e-6, 1.0 - 1e-6)
    hnr = 10.0 * np.log10(s / (1.0 - s))
    return {"f0": f0, "f0_strength": strength, "hnr_db": np.where(f0 > 0, hnr, -np.inf)}


def tf32_np(x: np.ndarray) -> np.ndarray:
    """`tf32` for NumPy arrays: float32, then the 10-bit significand."""
    return tf32(torch.as_tensor(np.asarray(x, np.float32))).numpy().astype(np.asarray(x).dtype)


def analyze_block(samples: np.ndarray, lengths, padded_frames: int, cfg: dict, dtype=torch.float64,
                  device="cpu", rnd=None, follow: list | None = None, select: list | None = None) -> list[dict]:
    """Reference features of each recording of a block that has a frame: a
    list of dicts of NumPy arrays, with `local_peak`, every frame's peak.

    samples (B, S) float32, lengths (B,); padded_frames: the frame count of
    the block's padded axis (the path search runs over it, the padding
    frames holding only the unvoiced candidate). The frames of all
    recordings run through the frame-local stages together,
    `CHUNK_FRAMES` at a time.

    select: per recording, the sorted frame indices to compute (None: all).
    follow: per recording, the program's {"formant_freqs", "formant_bws"}
    over all its frames: each selected frame's tracker step starts from the
    program's previous frame (the seed at frame 0). Without `follow` the
    tracker, and with the path search the path, run over all frames (the
    control, in the program's place), so `select` must then be None."""
    if follow is None and select is not None:
        raise ValueError("a frame selection needs the program's tracked formants to follow")
    control = rnd is not None
    rnd = rnd or (lambda x: x)
    n, hop = cfg["frame_len"], cfg["hop"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control
    try:
        counts = [nf for nf in (num_frames(int(length), n, hop) for length in lengths) if nf > 0]
        every = [torch.as_tensor(samples[b, : (nf - 1) * hop + n]).to(device=device, dtype=dtype).unfold(-1, n, hop)
                 for b, nf in enumerate(counts)]
        peaks = [torch.amax(torch.abs(f), dim=-1).cpu().numpy() for f in every]
        sel = select or [np.arange(nf) for nf in counts]
        frames = torch.cat([f[torch.as_tensor(ix, device=f.device)] for f, ix in zip(every, sel)])
        del every
        parts = [_frame_features(frames[i : i + CHUNK_FRAMES].contiguous(), cfg, rnd)
                 for i in range(0, frames.shape[0], CHUNK_FRAMES)]
        del frames
        feats = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        del parts
        recs = [dict(zip(feats, vals)) for vals in zip(*(torch.split(v, [len(ix) for ix in sel])
                                                          for v in feats.values()))]
        est_f = torch.as_tensor(cfg["formant"]["estimates"], dtype=dtype, device=device)
        est_b = torch.full_like(est_f, cfg["formant"]["estimate_bandwidth"])
        for i, r in enumerate(recs):
            rf, rb = r.pop("res_f"), r.pop("res_b")
            if follow is not None:
                ix = torch.as_tensor(sel[i], device=device)
                pf = torch.as_tensor(follow[i]["formant_freqs"], device=device).to(dtype)
                pb = torch.as_tensor(follow[i]["formant_bws"], device=device).to(dtype)
                r["formant_freqs"], r["formant_bws"] = serial.track_from(rf, rb, est_f, est_b, pf, pb, ix)
            else:
                tf, tb = serial.track_serial(rf.cpu().numpy(), rb.cpu().numpy(), est_f.cpu().numpy(),
                                             est_b.cpu().numpy())
                r["formant_freqs"], r["formant_bws"] = (torch.as_tensor(t, dtype=dtype) for t in (tf, tb))
        out = [{k: v.cpu().numpy() for k, v in r.items()} for r in recs]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if cfg["pitch"]["viterbi"] and follow is None:
        idx = path_indices([r["pitch_candidates_freq"] for r in out], [r["pitch_candidates_strength"] for r in out],
                           [r["pitch_candidates_valid"] for r in out], peaks, padded_frames, cfg,
                           rnd=tf32_np if control else None)
    elif cfg["pitch"]["viterbi"]:
        idx = [None] * len(out)  # the path needs every frame's candidates: the check takes the program's
    else:
        idx = [np.zeros(r["rms"].shape[0], np.int64) for r in out]
    for r, ix, lp in zip(out, idx, peaks):
        r["local_peak"] = lp
        if ix is None:
            continue
        f0 = np.take_along_axis(r["pitch_candidates_freq"], ix[:, None], axis=1)[:, 0]
        s0 = np.take_along_axis(r["pitch_candidates_strength"], ix[:, None], axis=1)[:, 0]
        r.update(f0_outputs(f0, s0))
    return out


def path_indices(freqs, strengths, valids, peaks, padded_frames: int, cfg: dict, rnd=None) -> list:
    """The path's candidate index at each real frame of each recording of a
    block (lists of (F_b, C) candidates and (F_b,) frame peaks), the paths
    searched together over `padded_frames` frames: each recording's real
    frames, then zero frames, each of which holds only the unvoiced
    candidate at slot 0. `rnd` rounds the running scores (the control)."""
    B, C = len(freqs), freqs[0].shape[1]
    freq = np.zeros((B, padded_frames, C))
    strength = np.zeros((B, padded_frames, C))
    valid = np.zeros((B, padded_frames, C), bool)
    lp = np.zeros((B, padded_frames))
    strength[:, :, 0] = cfg["pitch"]["threshold"]
    valid[:, :, 0] = True
    for b in range(B):
        F = freqs[b].shape[0]
        freq[b, :F], strength[b, :F], valid[b, :F], lp[b, :F] = freqs[b], strengths[b], valids[b], peaks[b]
    path = dict(cfg["path"], ceiling=cfg["pitch"]["fmax"])
    local, fs, voiced = serial.path_inputs(freq, strength, valid, serial.intensity(lp), path)
    idx = serial.viterbi(local, fs, voiced, path, rnd=rnd)
    return [idx[b, : freqs[b].shape[0]] for b in range(B)]
