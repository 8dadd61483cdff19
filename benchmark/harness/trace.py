"""The traced stretch: device activities from `torch.profiler`, the
benchmark's own host spans, host syncs, and the arithmetic over them.

`profile_blocks` runs whole blocks under the profiler after one untraced
warm-up block, with `PAD_S` of idle host time before and after the
stretch: the card's activity clock and the host's disagree by a fraction
of a millisecond, so an activity at the edge of a profiler step can land
on the wrong side of it (the padding of `chip_smoke.profile_path`). The
stretch is one annotation; its length is the traced window. Busy time is
the union of the device activities' intervals inside it.

`host_syncs` counts the syncs a call makes, with the Python line of each,
from `torch.cuda.set_sync_debug_mode("warn")` (a copy of
`voxtpu_torch.bench.host_syncs`).
"""

from __future__ import annotations

import re
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

PAD_S = 0.02
STRETCH = "benchmark traced stretch"
# The benchmark's own host spans around the calls of one block.
SPANS = ("next_block", "copy_in", "entry", "fetch")
_COPY = re.compile(r"^(Memcpy|Memset)")
_H2D_D2H = re.compile(r"Memcpy (HtoD|DtoH)")


@dataclass
class Activity:
    name: str
    start: float  # seconds, the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What a metric reader gets: the device activities inside the traced
    window, the window, the host spans, the traced blocks, the host syncs
    of a pass over the same blocks, and the cell's configuration and the
    port's kernel names."""

    activities: list
    window: tuple
    spans: list
    blocks: list
    syncs: int
    sync_blocks: int
    config: dict
    kernel_names: frozenset

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the activities' intervals, merged, in order."""
        merged = []
        for a in sorted(self.activities, key=lambda a: a.start):
            if merged and a.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], a.end)
            else:
                merged.append([a.start, a.end])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def is_port_kernel(self, name: str) -> bool:
        return kernel_of(name, self.kernel_names) is not None

    @staticmethod
    def is_copy(name: str) -> bool:
        return bool(_COPY.search(name))

    @staticmethod
    def is_host_device_copy(name: str) -> bool:
        return bool(_H2D_D2H.search(name))

    def seconds_of(self, pred) -> float:
        return sum(a.seconds for a in self.activities if pred(a.name))

    def real_frames(self) -> int:
        return sum(sum(b.frames) for b in self.blocks)


def kernel_of(activity: str, names) -> str | None:
    """The port's kernel an activity name is, matched as a whole word
    (`void burg_kernel<float>(...)` is `burg_kernel`), or None."""
    for word in re.findall(r"[A-Za-z_][A-Za-z_0-9]*", activity):
        if word in names:
            return word
    return None


def kernel_names(path: Path) -> frozenset:
    """The port's kernel names, one a line of `path` (# starts a comment)."""
    with open(path) as f:
        return frozenset(w for w in (line.split("#")[0].strip() for line in f) if w)


def host_syncs(fn) -> list[str]:
    """The host syncs `fn()` makes on the card, as "file:line" of the
    Python call that made each."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def profile_blocks(run_block, order: list) -> tuple[list, tuple, list]:
    """Run `run_block(i, span)` for each pool index of `order` under the
    profiler, after one warm-up block in the profiler's warm-up step.
    `span(name)` opens a host span. Returns (device activities, the traced
    window (start, end), host spans [(name, start, end)]), in seconds of
    the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run_block(order[0], record_function)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PAD_S)
        with record_function(STRETCH):
            for i in order:
                run_block(i, record_function)
            torch.cuda.synchronize()
        time.sleep(PAD_S)
        prof.step()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    stretch = [e for e in events if e.name == STRETCH and e.device_type != cuda]
    if len(stretch) != 1:
        raise RuntimeError(f"the profiler recorded {len(stretch)} traced stretches, not 1")
    w0, w1 = stretch[0].time_range.start / 1e6, stretch[0].time_range.end / 1e6
    acts, spans = [], []
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda and not e.is_user_annotation:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                acts.append(Activity(e.name, s, t))
        elif e.name in SPANS and e.device_type != cuda:
            spans.append((e.name, s, t))
    if not acts:
        raise RuntimeError("the profiler recorded no device activity in the traced stretch")
    return acts, (w0, w1), spans


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations with the most time, and the longest idle gaps
    inside the window, each named by the host span open at its start."""
    by_name: dict = {}
    for a in trace.activities:
        by_name[a.name] = by_name.get(a.name, 0.0) + a.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], trace.window[0]
    for s, e in trace.busy_intervals() + [[trace.window[1], trace.window[1]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t):
        open_ = [(n, s) for n, s, e in trace.spans if s <= t < e]
        return max(open_, key=lambda ns: ns[1])[0] if open_ else "between_spans"

    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(s), e - s] for s, e in gaps[:top]]}
