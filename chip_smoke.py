#!/usr/bin/env python3
"""Drive voxtpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It fails (nonzero exit, no result lines) without a CUDA device or outside a
checkout. Phases, each an uncaught exception when it fails:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the four kernels from voxtpu_torch/csrc with nvcc, with the
   compiler's register report;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the slice (CLI_DEFAULT_44K over 126 tiles of the bundled two-vowels
   recording: 35,689 frames of 2205 samples), in float64 and float32;
4. the slice: `analyze` in float32 on the card, with every kernel's launch
   count reset just before and read just after; all four must have run,
   outputs must be finite (hnr_db is -inf exactly where f0 == 0) and every
   frame's status 0;
5. parity: float64 on the card through the kernels against the plain CPU
   path over the first 2 s, and float32 against float64 on the card over
   the whole signal within the fast-mode budgets, where a frame over a
   budget must be over it in the plain path too (see `check_budgets`);
6. times: end to end, one run under torch.profiler (device busy time, idle
   share, the activities with the most device time), and each kernel
   against its plain version.

Each phase prints the seconds it took.

The line before the last is one JSON object with each kernel's launches,
error and times; the last is the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "sample-two_vowels.wav"
TILES = 126  # ~357 s of real speech
EXPECTED_FRAMES = 35689
KNIFE = 1e-3  # |lag - round(lag)| under which the integer-snap branch decides Brent's path

# Fast-mode budgets, float32 against float64 (tests/test_fast_mode.py:72-79).
BUDGETS = {"f0": 0.7, "f0_strength": 1e-2, "formant_freqs": 2.5, "mfcc": 1e-4}

KERNELS = {
    # name: (source, replaced TPU kernel)
    "refine": ("voxtpu_torch/csrc/refine.cu", "voxtpu/ops/refine_pallas.py:286"),
    "burg": ("voxtpu_torch/csrc/burg.cu", "voxtpu/ops/burg_pallas.py:80"),
    "find_roots": ("voxtpu_torch/csrc/roots.cu", "voxtpu/ops/roots_pallas.py:208"),
    "formant_scan": ("voxtpu_torch/csrc/formant_scan.cu", "voxtpu/ops/formant_scan_pallas.py:249"),
}


class Checks:
    """Comparisons of one run; `raise_failures` raises them all at once."""

    def __init__(self):
        self.failures: list[str] = []

    def close(self, name, got, want, rtol, atol, mask=None) -> float:
        """|got - want| <= atol + rtol |want| elementwise (non-finite values
        must agree exactly); returns the max abs error over finite pairs."""
        import torch

        got, want = got.double(), want.double()
        if mask is not None:
            got, want = got[mask], want[mask]
        both = torch.isfinite(got) & torch.isfinite(want)
        err = torch.where(both, (got - want).abs(), 0.0)
        bad = both & (err > atol + rtol * want.abs())
        nonfinite = (torch.isfinite(got) != torch.isfinite(want)) | (
            ~both & (got != want) & ~(torch.isnan(got) & torch.isnan(want))
        )
        max_err = float(err.max()) if err.numel() else 0.0
        nbad = int(bad.sum()) + int(nonfinite.sum())
        print(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol:g}, atol {atol:g}), {nbad} outside")
        if nbad:
            self.failures.append(f"{name}: {nbad} of {got.numel()} values outside tolerance, max_abs_err {max_err:.3e}")
        return max_err

    def equal(self, name, got, want) -> None:
        nbad = int((got != want).sum())
        print(f"  {name}: {nbad} of {got.numel()} differ")
        if nbad:
            self.failures.append(f"{name}: {nbad} of {got.numel()} values differ")

    def true(self, name, ok: bool, detail: str = "") -> None:
        print(f"  {name}: {'ok' if ok else 'FAILED'} {detail}")
        if not ok:
            self.failures.append(f"{name} {detail}")

    def raise_failures(self) -> None:
        if self.failures:
            raise AssertionError("chip_smoke checks failed:\n  " + "\n  ".join(self.failures))


def sync_ms(fn, runs: int = 5) -> float:
    """Median host-clock ms of `runs` warm runs, each ending in a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_inputs(frames, cfg):
    """Each kernel's arguments at the slice's shapes, computed by the port's
    own stages from (F, n) raw frames."""
    import torch

    from voxtpu_torch.formants import formant_candidates
    from voxtpu_torch.ops.burg import burg
    from voxtpu_torch.pitch import REFINE_SINC_DEPTH, lag_candidates
    from voxtpu_torch.sinc import _max_effective_depth
    from voxtpu_torch.windows import hann

    n = frames.shape[-1]
    window = torch.as_tensor(hann(n), dtype=frames.dtype, device=frames.device)
    p, f = cfg.pitch, cfg.formant
    lc = lag_candidates(frames * window, cfg.sample_rate, p.fmin, p.fmax, p.max_candidates)
    T = _max_effective_depth(lc.offset, lc.nx, REFINE_SINC_DEPTH, lc.max_x + 1.0)
    refine_args = (lc.self_lag, lc.pos, lc.valid, lc.offset, REFINE_SINC_DEPTH, T)
    burg_args = ((frames * window).contiguous(), f.n_coeffs)
    coeffs, _ = burg(*burg_args)
    poly_re = torch.cat([coeffs.flip(-1), torch.ones_like(coeffs[:, :1])], dim=-1).contiguous()
    roots_args = (poly_re, torch.zeros_like(poly_re))
    rfreq, rbw, _ = formant_candidates(frames, cfg.sample_rate, f.n_coeffs, polish=f.polish)
    est_f = torch.as_tensor(f.estimates, dtype=frames.dtype, device=frames.device)
    scan_args = (rfreq, rbw, est_f, torch.full_like(est_f, f.estimate_bandwidth))
    return {"refine": refine_args, "burg": burg_args, "find_roots": roots_args, "formant_scan": scan_args}, lc.valid


def check_kernels(frames, cfg, checks: Checks) -> dict:
    """Phase 3 for one dtype: every kernel against its plain version on the
    same inputs. Returns {kernel: max_abs_err}."""
    import torch

    from voxtpu_torch.ops import burg, find_roots, formant_scan, refine

    dt = frames.dtype
    f64 = dt == torch.float64
    tag = "f64" if f64 else "f32"
    args, valid = kernel_inputs(frames, cfg)
    errs = {}

    xk, fk = refine.refine(*args["refine"])
    xp, fp = refine.refine_plain(*args["refine"])
    if f64:
        # tests/test_pallas.py:51-52: Brent's trajectory is chaotic in the
        # last ulp, so agreement is to Brent's tolerance.
        e1 = checks.close("refine x [f64]", xk, xp, 1e-6, 1e-5, mask=valid)
    else:
        # The f32 fuzz test's bracket (tests/test_pallas.py:224-235): Brent
        # stops at tol_act ~ sqrt(eps_f32)|x|. Where the start or either
        # result sits within KNIFE of an integer, the integer-snap branch
        # decides which side of a flat top Brent ends on (the knife edge of
        # tests/test_traces_16k.py:64-76): there the lag agrees to rtol 5e-3
        # and f(x) to the fuzz tolerance below.
        x0 = args["refine"][1]
        knife = torch.zeros_like(valid)
        for x in (x0, xk, xp):
            knife |= (x - x.round()).abs() < KNIFE
        lag = xp + args["refine"][3]
        ok = ((xk - xp).abs() <= 0.2) | (knife & ((xk - xp).abs() <= 5e-3 * lag.abs()))
        e1 = float((xk - xp)[valid].abs().max())
        nknife = int((valid & knife & ((xk - xp).abs() > 0.2)).sum())
        checks.true("refine x [f32]", bool(ok[valid].all()),
                    f"max_abs_err {e1:.3e} (atol 0.2; {nknife} knife-edge lanes beyond it, within lag rtol 5e-3)")
    ftol = (1e-5, 1e-7) if f64 else (1e-3, 5e-4)
    e2 = checks.close(f"refine f(x) [{tag}]", fk, fp, *ftol, mask=valid)
    errs["refine"] = max(e1, e2)

    ck, sk = burg.burg(*args["burg"])
    cp, sp = burg.burg_plain(*args["burg"])
    # f64: tests/test_pallas.py:160. f32: both sum in float64, in different
    # orders, so a reflection coefficient can round to float32 on either side
    # of a tie (1 ulp), and later orders carry that on.
    errs["burg"] = checks.close(f"burg coeffs [{tag}]", ck, cp, *((1e-10, 1e-12) if f64 else (1e-4, 1e-5)))
    checks.equal(f"burg status [{tag}]", sk, sp)

    rk = find_roots.find_roots(*args["find_roots"])
    rp = find_roots.find_roots_plain(*args["find_roots"])
    # f64: 1e-9 on unit-circle roots. f32: Laguerre runs all 20 steps at f32
    # resolution and deflation carries each root's error into the next.
    rtol_atol = (1e-9, 1e-9) if f64 else (1e-3, 1e-3)
    e1 = checks.close(f"roots re [{tag}]", rk[0], rp[0], *rtol_atol)
    e2 = checks.close(f"roots im [{tag}]", rk[1], rp[1], *rtol_atol)
    errs["find_roots"] = max(e1, e2)
    checks.equal(f"roots count [{tag}]", rk[2], rp[2])
    checks.equal(f"roots status [{tag}]", rk[3], rp[3])

    # Bit-exact over the first 4,096 frames, as one recording (the slice's
    # call) and as 8 recordings of 512 frames (the carry resets at each). The
    # plain scan is a Python loop over frames: it runs on CPU copies, where
    # a step takes a fraction of its time on the card.
    rf, rb, ef, eb = args["formant_scan"]
    head = [t.cpu() for t in (rf[:4096], rb[:4096], ef, eb)]
    err = 0.0
    for label, frames_in, file_len in (("one recording", len(rf), None), ("8 x 512 frames", 4096, 512)):
        fk_, bk_ = formant_scan.formant_scan(rf[:frames_in], rb[:frames_in], ef, eb, file_len=file_len)
        fk_, bk_ = fk_[:4096].cpu(), bk_[:4096].cpu()
        fp_, bp_ = formant_scan.formant_scan_plain(*head, file_len=file_len)
        checks.equal(f"formant_scan freqs [{tag}, first 4096 frames, {label}]", fk_, fp_)
        checks.equal(f"formant_scan bws [{tag}, first 4096 frames, {label}]", bk_, bp_)
        err = max(err, float((fk_ - fp_).abs().max()), float((bk_ - bp_).abs().max()))
    errs["formant_scan"] = err
    return errs


def knife_rtol(f0, sample_rate: float, base: float):
    """Per-frame f0/strength rtol: `base`, or 5e-3 where the refined lag sits
    within KNIFE of an integer (tests/test_traces_16k.py:64-76)."""
    import torch

    lag = torch.where(f0 > 0, sample_rate / f0, 0.0)
    return torch.where((lag - lag.round()).abs() < KNIFE, 5e-3, base)


def compare_slice(name, got: dict, want: dict, sample_rate: float, checks: Checks) -> None:
    """The CPU slice test's tolerances (tests/test_torch_pipeline.py)."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    for key in ("f0", "f0_strength"):
        rt = knife_rtol(want["f0"], sample_rate, 1e-5)
        err = (got[key] - want[key]).abs()
        nbad = int((err > 1e-8 + rt * want[key].abs()).sum())
        checks.true(f"{name} {key}", nbad == 0, f"max_abs_err {float(err.max()):.3e}, {nbad} outside")
    checks.close(f"{name} rms", got["rms"], want["rms"], 1e-12, 0.0)
    checks.close(f"{name} mfcc", got["mfcc"], want["mfcc"], 1e-9, 1e-9)
    checks.close(f"{name} formant_freqs", got["formant_freqs"], want["formant_freqs"], 1e-7, 1e-5)
    checks.close(f"{name} formant_bws", got["formant_bws"], want["formant_bws"], 1e-6, 1e-4)
    checks.equal(f"{name} status", got["status"], want["status"])
    checks.equal(f"{name} hnr_db finite", torch.isfinite(got["hnr_db"]), torch.isfinite(want["hnr_db"]))


def check_budgets(out32: dict, out64: dict, signal: np.ndarray, cfg, checks: Checks) -> None:
    """float32 against float64 on the card within BUDGETS; float64 is the
    only reference.

    float32 at the 2205/441 framing breaks the f0 budget in the plain
    version too (PERF.md). So every frame over a budget on the card is
    looked up in the plain CPU path, its float32 against its own float64 on
    that frame: the check fails unless the plain path is over the budget
    there too."""
    import dataclasses

    import torch

    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops.formant_scan import formant_scan
    from voxtpu_torch.pipeline import analyze_frames

    dev = out32["f0"].device
    frames = frame_signal(torch.as_tensor(signal), cfg.frame_len, cfg.hop)

    def frame_err(key, a, b, f0_64):
        err = (a.cpu().double() - b.cpu().double()).abs()
        if err.dim() > 1:
            err = err.amax(dim=-1)
        # the f0 budget holds on frames voiced in float64
        return torch.where(f0_64.cpu() > 0, err, 0.0) if key == "f0" else err

    def off(stage_cfg):
        return dataclasses.replace(stage_cfg, enabled=False)

    def plain(key, idx, dt):
        """The plain CPU path's (key, f0) at frames idx, in dtype dt."""
        if key != "formant_freqs":  # frame-local: those frames alone
            out = analyze_frames(frames[idx].to(dt), dataclasses.replace(cfg, formant=off(cfg.formant)))
            return out[key], out["f0"]
        # The tracker carries its estimates from frame to frame: candidates of
        # every frame up to the last one in idx, tracked by kernel D on the
        # card (bit-exact with its plain version, phase 3).
        sub = dataclasses.replace(cfg, pitch=off(cfg.pitch), mfcc=off(cfg.mfcc))
        out = analyze_frames(frames[: int(idx.max()) + 1].to(dt), sub, return_formant_candidates=True)
        est = torch.as_tensor(cfg.formant.estimates, dtype=dt, device=dev)
        freqs, _ = formant_scan(out["resonance_freqs"].to(dev), out["resonance_bws"].to(dev), est,
                                torch.full_like(est, cfg.formant.estimate_bandwidth))
        return freqs[idx.to(dev)], None

    for key, budget in BUDGETS.items():
        err = frame_err(key, out32[key], out64[key], out64["f0"])
        idx = (err > budget).nonzero().flatten()
        detail = f"max_abs_err {float(err.max()):.3e} (budget {budget:g}), {len(idx)} frames over"
        plain_over = torch.ones(len(idx), dtype=torch.bool)
        if len(idx):
            v32, _ = plain(key, idx, torch.float32)
            v64, f0_64 = plain(key, idx, torch.float64)
            perr = frame_err(key, v32, v64, f0_64)
            plain_over = perr > budget
            detail += (f"; the plain CPU path's float32 is over it on {int(plain_over.sum())} of them "
                       f"(max {float(perr.max()):.3e})")
            if not plain_over.all():
                detail += (f"; not on frames {idx[~plain_over].tolist()[:8]}: card err "
                           f"{err[idx][~plain_over].tolist()[:8]}, plain err {perr[~plain_over].tolist()[:8]}")
        checks.true(f"f32 {key}", bool(plain_over.all()), detail)


def profile_slice(sig, cfg, card: str) -> None:
    """One warm `analyze` under torch.profiler. From the trace alone: the
    device's busy time (union of its activities' intervals), the traced span
    (first recorded op to last end) and so the idle share, and the
    activities with the most device time. The profiler's own host cost
    lengthens the launch gaps, so the idle share here is an upper bound."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from voxtpu_torch.pipeline import analyze

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        analyze(sig, cfg)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, cur_start, cur_end = 0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        if cur_end is None or start > cur_end:
            busy += 0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    print(f"profile, one warm float32 analyze [{card}]: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms traced span, idle share {1 - busy / span:.4f}; {len(device)} device activities")
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:100]}")


def main() -> None:
    if not (ROOT / "voxtpu_torch" / "csrc").is_dir() or not FIXTURE.is_file():
        raise SystemExit("chip_smoke.py runs from the root of a voxtpu checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import burg, find_roots, formant_scan, kernels, refine
    from voxtpu_torch.pipeline import CLI_DEFAULT_44K, analyze

    ops = {"refine": refine, "burg": burg, "find_roots": find_roots, "formant_scan": formant_scan}
    checks = Checks()
    t_start = t_phase = time.perf_counter()

    def phase_took(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[{name}: {now - t_phase:.1f} s]")
        t_phase = now

    # --- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    # --- 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.relative_to(ROOT)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    kernels.library()

    # --- data: 126 tiles of the bundled recording
    cfg = CLI_DEFAULT_44K
    sr = cfg.sample_rate
    wav = read_wav(str(FIXTURE))
    signal = np.tile(np.asarray(wav.samples, dtype=np.float64), TILES)
    sig64 = torch.as_tensor(signal, device=dev)
    sig32 = sig64.float()
    frames64 = frame_signal(sig64, cfg.frame_len, cfg.hop)
    F = frames64.shape[0]
    audio_s = len(signal) / sr
    print(f"slice: {len(signal)} samples ({audio_s:.1f} s), {F} frames of {cfg.frame_len}, hop {cfg.hop}")
    checks.true("frame count", F == EXPECTED_FRAMES, f"{F}")

    # --- 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernels vs plain, float64:")
    errs64 = check_kernels(frames64, cfg, checks)
    print("kernels vs plain, float32:")
    errs32 = check_kernels(frames64.float(), cfg, checks)
    del frames64
    phase_took("phase 3, kernels vs plain")

    # --- 4. the slice, float32
    analyze(sig32[: 50 * cfg.hop + cfg.frame_len], cfg)  # warm cuFFT plans and caches
    torch.cuda.synchronize()
    for name, op in ops.items():
        getattr(op, name).launches = 0
    out32 = analyze(sig32, cfg)
    torch.cuda.synchronize()
    launches = {name: getattr(op, name).launches for name, op in ops.items()}
    print(f"slice float32: launches {launches}")
    for name, count in launches.items():
        checks.true(f"{name} launched on the main path", count > 0, f"({count})")
    shapes = {k: tuple(v.shape) for k, v in out32.items()}
    checks.true("output shapes", shapes["f0"] == (F,) and shapes["formant_freqs"] == (F, 4)
                and shapes["mfcc"] == (F, 13) and shapes["pitch_candidates_freq"] == (F, 33), str(shapes))
    for k, v in out32.items():
        if v.is_floating_point():
            fin = torch.isfinite(v)
            if k == "hnr_db":
                checks.true("hnr_db finite exactly where f0 > 0", bool((fin == (out32["f0"] > 0)).all()))
                fin = fin | (v == -np.inf)
            checks.true(f"{k} finite", bool(fin.all()))
    checks.true("status 0 on every frame", int(out32["status"].count_nonzero()) == 0,
                f"({int(out32['status'].count_nonzero())} nonzero)")
    voiced = out32["f0"] > 0
    print(f"  voiced frames: {int(voiced.sum())} of {F}; median f0 {float(out32['f0'][voiced].median()):.2f} Hz, "
          f"median F1 {float(out32['formant_freqs'][:, 0].median()):.1f} Hz")
    phase_took("phase 4, the slice")

    # --- 5. parity
    print("parity: float64 on the card vs the plain CPU path, first 2 s:")
    head = signal[: int(2 * sr)]
    card64 = analyze(torch.as_tensor(head, device=dev), cfg)
    cpu64 = analyze(torch.as_tensor(head), cfg)
    compare_slice("f64 card vs cpu", card64, cpu64, sr, checks)
    phase_took("phase 5, float64 parity")

    print("parity: float32 vs float64 on the card, whole signal:")
    out64 = analyze(sig64, cfg)
    check_budgets(out32, out64, signal, cfg, checks)
    del out64, card64, cpu64
    phase_took("phase 5, float32 budgets")

    # --- 6. times (float32, the slice's shapes)
    e2e_ms = sync_ms(lambda: analyze(sig32, cfg))
    print(f"end to end, float32: {e2e_ms:.2f} ms for {audio_s:.1f} s of audio = {audio_s / (e2e_ms / 1e3):.1f} "
          f"audio-s/s [{card}]")
    profile_slice(sig32, cfg, card)
    args32, _ = kernel_inputs(frame_signal(sig32, cfg.frame_len, cfg.hop), cfg)
    prefix = 256  # the plain scan is a Python loop over frames: time a prefix
    rf, rb, ef, eb = args32["formant_scan"]
    timing = {
        "refine": (lambda: refine.refine(*args32["refine"]), lambda: refine.refine_plain(*args32["refine"]), F),
        "burg": (lambda: burg.burg(*args32["burg"]), lambda: burg.burg_plain(*args32["burg"]), F),
        "find_roots": (lambda: find_roots.find_roots(*args32["find_roots"]),
                       lambda: find_roots.find_roots_plain(*args32["find_roots"]), F),
        "formant_scan": (lambda: formant_scan.formant_scan(rf, rb, ef, eb),
                         lambda: formant_scan.formant_scan_plain(rf[:prefix], rb[:prefix], ef, eb), prefix),
    }
    rows = []
    for name, (kfn, pfn, plain_frames) in timing.items():
        ms = sync_ms(kfn)
        plain_ms = sync_ms(pfn)
        print(f"  {name}: kernel {ms:.3f} ms ({F} frames), plain {plain_ms:.3f} ms ({plain_frames} frames)")
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs32[name], "max_abs_err_f64": errs64[name],
            "ms": ms, "plain_ms": plain_ms, "frames": F, "plain_frames": plain_frames,
        })

    phase_took("phase 6, times")
    print(f"[chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check]")
    checks.raise_failures()
    print(json.dumps({"e2e_ms": e2e_ms, "audio_s_per_s": audio_s / (e2e_ms / 1e3), "frames": F, "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
