"""Profiling and observability (port of voxtpu.profiling).

- `trace(logdir)`: a context manager around `torch.profiler` (CPU and, when
  a card is present, CUDA activity) that writes a Chrome trace into
  `logdir` (open it in chrome://tracing or Perfetto);
- `timed(fn, *args)`: best-of wall-clock seconds, each run ending in
  `torch.cuda.synchronize()` when a card is present, because CUDA launches
  return before the device finishes;
- `stage_report(frames, config)`: `timed` of `analyze_frames` per feature
  subset (rms, mfcc, formants, pitch, full).

A time from a CPU run is a CPU time: name the device beside any number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["trace", "timed", "stage_report"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace lands in `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Best-of wall-clock seconds for fn(*args), each run synchronised."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def stage_report(frames, config, iters: int = 3) -> dict:
    """Best-of seconds of `analyze_frames` over `frames` for each feature
    subset: {"rms", "mfcc", "formants", "pitch", "full"}."""
    from voxtpu_torch.pipeline import analyze_frames

    def variant(**kw):
        c = config
        for k, v in kw.items():
            c = dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), enabled=v)})
        return c

    combos = {
        "rms": variant(pitch=False, formant=False, mfcc=False),
        "mfcc": variant(pitch=False, formant=False, mfcc=True),
        "formants": variant(pitch=False, formant=True, mfcc=False),
        "pitch": variant(pitch=True, formant=False, mfcc=False),
        "full": config,
    }
    return {name: timed(lambda f, c=cfg: analyze_frames(f, c), frames, iters=iters)
            for name, cfg in combos.items()}
