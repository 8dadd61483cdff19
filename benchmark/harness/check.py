"""The comparison that decides `correct`.

`compare_block` takes what the timed path returned for a block's
recordings (host arrays over their real frames) and the plain reference's
features of a sample of those frames (`select_frames`;
`benchmark.reference.analysis.analyze_block`), and gives for each
recording the numbers below; `merge` takes them over recordings and
blocks, and `verdict` holds them to the cell's limits
(`benchmark/limits/<cell>.json`). The numbers a cell's limits name are
compared; the rest are printed only.

Compared:
- `mfcc_gap`: the largest |difference| of an MFCC (log10 units);
- `rms_gap`: the largest |difference| of a frame's RMS over the reference's;
- `status_diff`: frames whose status differs (an exact comparison);
- `cand_count_share`: the share of frames whose count of valid pitch
  candidates differs;
- `cand_lag_gap_tol_p99`: kernel A's answers: over the voiced candidates
  of frames whose counts agree, each frame's sorted by frequency, the 99th
  percentile of the |difference| of the candidates' lags (sample rate over
  frequency) in units of Brent's float32 stopping tolerance at that lag
  (`brent_tol`);
- `formant_flip_share`: the share of tracked formant values more than
  50 Hz apart: the tracker took another resonance than the reference's
  step from the program's own previous frame does;
- `formant_gap_hz_p99`: the 99th percentile of the |differences| of the
  other tracked formant values;
- `pick_share`, over every frame: the share whose f0 and strength are not
  the candidate that the configuration's rule picks from the program's
  own candidates (the strongest; with the path search, the float64 path
  over them and the reference's frame peaks), or whose HNR is not that
  strength's.
Printed: the largest lag gap in tolerances (`cand_lag_gap_tol`), the
largest and the 99th-percentile |difference| of the candidates' frequencies, each frame's sorted, over frames whose counts
agree (`cand_gap_hz`, `cand_gap_hz_p99`), the largest formant gap, and
where the reference has f0 (without the path search: the strongest
candidate) the share of frames whose f0 is another answer (voiced on one
side, or more than 1% apart), the largest and 99th-percentile f0 gap
over the other voiced frames, and the same of the strength.
"""

from __future__ import annotations

import numpy as np

F0_FLIP_REL = 0.01
FORMANT_FLIP_HZ = 50.0


def brent_tol(lag: np.ndarray, frame_len: int) -> np.ndarray:
    """Brent's stopping tolerance in float32 at `lag` samples: the search
    runs over x = lag - offset, offset = -floor(n / 2) - 1, and stops once
    x is within about sqrt(eps) |x| + tol / 3 of the optimum
    (`benchmark.reference.stages._brent`, `pitch_candidates`)."""
    offset = -(frame_len // 2) - 1
    return np.sqrt(np.finfo(np.float32).eps) * np.abs(lag - offset) + 1e-10 / 3.0


def other_f0(pf: np.ndarray, rf: np.ndarray) -> np.ndarray:
    """Frames whose f0 is another answer: voiced on one side only, or both
    voiced and more than `F0_FLIP_REL` apart."""
    pf, rf = pf.astype(np.float64), rf.astype(np.float64)
    return ((pf > 0) != (rf > 0)) | ((pf > 0) & (rf > 0) & (np.abs(pf - rf) > F0_FLIP_REL * np.abs(rf)))


def numbers(kept: list, pool: list, cfg: dict, mix: dict, seed: int, device) -> dict:
    """The check's numbers (`merge`) of the kept outputs, a list of (pool
    block index, the program's per-recording arrays), against the plain
    reference in float64 on `device` over the frames drawn from `seed`:
    `mix["check_frames"]` spread over the blocks, every recording's first
    frame and, with the path search, every frame of one recording a block."""
    import torch

    from benchmark.harness import traffic
    from benchmark.reference.analysis import analyze_block

    rng = traffic.rng_for(seed, 5)
    parts = []
    for i, recs in kept:
        blk = pool[i]
        whole = int(rng.integers(len(recs))) if cfg["pitch"]["viterbi"] else None
        select = select_frames(recs, mix["check_frames"] // len(kept), rng, whole)
        ref = analyze_block(blk.samples, blk.lengths, blk.padded_frames, cfg, torch.float64, device,
                            follow=recs, select=select)
        parts += compare_block(recs, ref, select, blk.padded_frames, cfg, whole)
    return merge(parts)


def recordings(out: dict, frames: list) -> list[dict]:
    """A block's returned arrays split into its recordings' real frames."""
    return [{k: v[i, :nf] for k, v in out.items()} for i, nf in enumerate(frames) if nf > 0]


def _max(x) -> float:
    return float(np.max(x)) if np.size(x) else 0.0


def _p99(x) -> float:
    return float(np.percentile(x, 99)) if np.size(x) else 0.0


def hnr_db32(strength: np.ndarray) -> np.ndarray:
    """HNR of float32 strengths as the program forms it, in float32."""
    s = np.clip(strength.astype(np.float32), np.float32(1e-6), np.float32(1.0 - 1e-6))
    return np.float32(10.0) * np.log10(s / (np.float32(1.0) - s))


def select_frames(prog: list, k: int, rng, whole: int | None = None) -> list:
    """About k frames of the recordings drawn with `rng`, every recording's
    first frame (the tracker's start) and every frame of recording `whole`:
    per recording, sorted frame indices."""
    counts = np.asarray([p["f0"].shape[0] for p in prog])
    total = int(counts.sum())
    take = np.zeros(total, bool)
    take[rng.choice(total, size=min(k, total), replace=False)] = True
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    take[starts] = True
    if whole is not None:
        take[starts[whole] : starts[whole] + counts[whole]] = True
    return [np.flatnonzero(t) for t in np.split(take, starts[1:])]


def compare_block(prog: list, ref: list, select: list, padded_frames: int, cfg: dict,
                  whole: int | None = None) -> list[dict]:
    """The numbers of each recording of a block (see the module): `prog`
    the program's arrays over every real frame, `ref` the reference's over
    the frames `select` names (every frame of recording `whole`; its frame
    peaks over every frame)."""
    if not len(prog) == len(ref) == len(select):
        raise ValueError(f"the program returned {len(prog)} recordings of a block of {len(ref)}")
    keys = ("pitch_candidates_freq", "pitch_candidates_strength", "pitch_candidates_valid")
    if cfg["pitch"]["viterbi"]:
        from benchmark.reference.analysis import path_indices

        picks = path_indices(*([p[k] for p in prog] for k in keys), [r["local_peak"] for r in ref],
                             padded_frames, cfg)
    else:
        picks = [np.zeros(p["f0"].shape[0], np.int64) for p in prog]
    out = []
    for p, r, ix, pick in zip(prog, ref, select, picks):
        F = r["local_peak"].shape[0]
        if any(v.shape[0] != F for v in p.values()):
            raise ValueError(f"the program returned another frame count than the recording's {F}")
        row = compare_frames({k: v[ix] for k, v in p.items()}, r, cfg["sample_rate"], cfg["frame_len"])
        row["frames_all"] = F
        row["pick_diff"] = pick_diff(p, pick)
        out.append(row)
    if cfg["pitch"]["viterbi"] and whole is not None:
        r = ref[whole]
        if select[whole].shape[0] != r["local_peak"].shape[0]:
            raise ValueError("the reference's own path needs every frame of its recording")
        own = path_indices(*([r[k]] for k in keys), [r["local_peak"]], padded_frames, cfg)[0]
        f0 = np.take_along_axis(r["pitch_candidates_freq"], own[:, None], axis=1)[:, 0]
        out[whole]["path_flips"] = int(np.count_nonzero(other_f0(prog[whole]["f0"], f0)))
        out[whole]["path_frames"] = int(f0.shape[0])
    return out


def pick_diff(prog: dict, pick: np.ndarray) -> int:
    """Frames whose f0 and strength are not the candidate `pick` names,
    or whose HNR is not that strength's (-inf where unvoiced)."""
    f0_want = np.take_along_axis(prog["pitch_candidates_freq"], pick[:, None], axis=1)[:, 0]
    s_want = np.take_along_axis(prog["pitch_candidates_strength"], pick[:, None], axis=1)[:, 0]
    hnr = prog["hnr_db"].astype(np.float64)
    hnr_ok = np.where(prog["f0"] > 0, np.abs(hnr - hnr_db32(prog["f0_strength"])) <= 1e-4, hnr == -np.inf)
    return int(np.count_nonzero((prog["f0"] != f0_want) | (prog["f0_strength"] != s_want) | ~hnr_ok))


def compare_frames(prog: dict, ref: dict, sample_rate: float, frame_len: int) -> dict:
    """The frame-local numbers of the same frames of one recording."""
    d = lambda k: prog[k].astype(np.float64) - ref[k].astype(np.float64)  # noqa: E731
    out = {"frames": ref["rms"].shape[0]}
    out["mfcc_gap"] = _max(np.abs(d("mfcc")))
    out["rms_gap"] = _max(np.abs(d("rms")) / np.maximum(np.abs(ref["rms"].astype(np.float64)), 1e-30))
    out["status_diff"] = int(np.count_nonzero(prog["status"] != ref["status"]))

    pc, rc = prog["pitch_candidates_valid"], ref["pitch_candidates_valid"]
    same_n = pc.sum(axis=1) == rc.sum(axis=1)
    out["cand_count_diff"] = int(np.count_nonzero(~same_n))
    pcf = np.sort(np.where(pc, prog["pitch_candidates_freq"].astype(np.float64), np.inf), axis=1)
    rcf = np.sort(np.where(rc, ref["pitch_candidates_freq"].astype(np.float64), np.inf), axis=1)
    live = np.isfinite(rcf) & same_n[:, None]
    out["cand_gaps"] = np.abs(pcf[live] - rcf[live])
    voiced = live & (rcf > 0)  # the unvoiced candidate (0 Hz) has no lag
    lag_p, lag_r = sample_rate / pcf[voiced], sample_rate / rcf[voiced]
    out["lag_gaps_tol"] = np.abs(lag_p - lag_r) / brent_tol(lag_r, frame_len)

    g = np.abs(d("formant_freqs"))
    flip = g > FORMANT_FLIP_HZ
    out["formant_flips"] = int(np.count_nonzero(flip))
    out["formant_values"] = int(g.size)
    out["formant_gaps"] = g[~flip]

    if "f0" in ref:
        pf, rf = prog["f0"].astype(np.float64), ref["f0"].astype(np.float64)
        other = other_f0(pf, rf)
        out["f0_flips"] = int(np.count_nonzero(other))
        out["f0_gaps"] = np.abs(pf - rf)[(pf > 0) & (rf > 0) & ~other]
        out["strength_gaps"] = np.abs(d("f0_strength"))[~other]
    return out


def merge(parts: list[dict]) -> dict:
    """The numbers over many recordings: the largest gaps and the 99th
    percentiles over every compared value, the summed counts as shares."""
    frames = max(sum(p["frames"] for p in parts), 1)
    total = lambda k: sum(p.get(k, 0) for p in parts)  # noqa: E731
    cat = lambda k: np.concatenate([p[k] for p in parts if k in p] or [np.zeros(0)])  # noqa: E731
    out = {
        "mfcc_gap": max((p["mfcc_gap"] for p in parts), default=0.0),
        "rms_gap": max((p["rms_gap"] for p in parts), default=0.0),
        "status_diff": total("status_diff"),
        "cand_count_share": total("cand_count_diff") / frames,
        "cand_lag_gap_tol_p99": _p99(cat("lag_gaps_tol")),
        "cand_gap_hz_p99": _p99(cat("cand_gaps")),
        "formant_flip_share": total("formant_flips") / max(total("formant_values"), 1),
        "formant_gap_hz_p99": _p99(cat("formant_gaps")),
        "pick_share": total("pick_diff") / max(total("frames_all"), 1),
        "cand_lag_gap_tol": _max(cat("lag_gaps_tol")),
        "cand_gap_hz": _max(cat("cand_gaps")),
        "formant_gap_hz": _max(cat("formant_gaps")),
    }
    if any("f0_flips" in p for p in parts):
        out.update(f0_flip_share=total("f0_flips") / frames, f0_gap_hz=_max(cat("f0_gaps")),
                   f0_gap_hz_p99=_p99(cat("f0_gaps")), strength_gap=_max(cat("strength_gaps")),
                   strength_gap_p99=_p99(cat("strength_gaps")))
    if any("path_frames" in p for p in parts):
        out["path_f0_flip_share"] = total("path_flips") / max(total("path_frames"), 1)
    out["frames_compared"] = total("frames")
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers: each
    has to be finite and at most its limit."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = float(numbers[name])
        shown[name] = {"value": v, "limit": limit}
        ok = ok and np.isfinite(v) and v <= limit
    return ok, shown
