"""The benchmark of voxtpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`BENCHMARK.json`'s `workloads`) names a configuration and a traffic
mix. Set-up builds the mix's pool of corpus blocks from the seed as pinned
host tensors and runs every block once (the kernel library's build on a
checkout's first run, cuFFT plans, the allocator). The window then runs a
closed loop, one block at a time from the pool in a seeded order, through
`voxtpu_torch.pipeline.analyze_batch_padded_fetch`, the corpus block's entry,
until `--seconds` have passed. With `--trace 1` a traced stretch of whole
blocks follows the window and the per-layer metrics are read from it
(`benchmark/metrics/<metric>.py`). Once the window has closed and the
program's device memory is freed, blocks drawn from the window's own
outputs are held to the plain reference (`benchmark/reference/`) and the
cell's limits (`benchmark/limits/<cell>.json`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared beside their limits, which are also the last lines of standard
error. Without a CUDA card, or with fewer than the cell asks for, the run
fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.check import recordings  # noqa: E402

FORBIDDEN = frozenset(["jax", "jaxlib", "flax", "voxtpu"])


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among `names` (the loaded modules by default)
    that are JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules if names is None else names)} & FORBIDDEN)


def reader(name: str, root: Path = ROOT):
    """The `read(trace)` function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Program:
    """The system under test over one pool: one block a call, as the
    corpus command runs a block, with the benchmark's host spans."""

    def __init__(self, pool, config, device):
        import torch

        from voxtpu_torch.pipeline import analyze_batch_padded_fetch

        self.pool, self.config, self.device = pool, config, device
        self.entry = analyze_batch_padded_fetch
        self.as_tensor = torch.as_tensor

    def run(self, i: int, span=lambda name: contextlib.nullcontext()) -> dict:
        with span("next_block"):
            blk = self.pool[i]
        with span("copy_in"):
            samples, lengths = blk.pinned or (self.as_tensor(blk.samples), self.as_tensor(blk.lengths))
            x = samples.to(self.device, non_blocking=True)
            lengths = lengths.to(self.device, non_blocking=True)
        with span("entry"):
            out = self.entry(x, lengths, self.config, trim_to=blk.trim)
        with span("fetch"):
            return {"block": i, "recordings": recordings(out, blk.frames)}


def window(prog: Program, order, seconds: float, keep: int, rng) -> dict:
    """The closed loop: blocks from `order` until `seconds` have passed.
    Counts the blocks whose features reached the host inside the window;
    keeps `keep` of their outputs, (pool index, recordings), a uniform
    sample drawn with `rng`."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    lat, blocks, kept = [], [], []
    audio, last, attempted = 0.0, t0, 0
    for i in order:
        if time.perf_counter() >= deadline:
            break
        attempted += 1
        a = time.perf_counter()
        out = prog.run(i)
        b = time.perf_counter()
        if b > deadline:
            break
        lat.append(b - a)
        blocks.append(i)
        audio += prog.pool[i].audio_s
        last = b
        n = len(lat) - 1
        if n < keep:
            kept.append((i, out["recordings"]))
        else:
            j = int(rng.integers(0, n + 1))
            if j < keep:
                kept[j] = (i, out["recordings"])
    return {"start": t0, "last": last, "latencies": lat, "blocks": blocks, "audio_s": audio,
            "attempted": attempted, "kept": kept}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev, reset: bool = False) -> int:
    """The device's peak allocation since the last reset (0 on the CPU)."""
    import torch

    if dev.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.harness import cell as cells

    try:
        c = cells.load(args.workload, ROOT)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < c.chips:
        print(f"benchmark: the cell needs {c.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    result = run(args, c, torch.device("cuda", 0))
    if result is None:
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, JAX or the JAX package", file=sys.stderr)
        return 3
    for name, s in result["check"].items():
        print(f"{name} {s['value']!r} limit {s['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(args, c, dev, root: Path = ROOT, pinned: bool = True) -> dict | None:
    """One run of cell `c` on `dev`: the result's object, or None where no
    block completed inside the window."""
    import numpy as np
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import check, trace, traffic

    torch.set_num_threads(2)
    cfg = c.config
    pcfg = cells.port_config(cfg)
    if cfg["pitch"]["viterbi"]:
        from voxtpu_torch.viterbi import PathConfig

        if PathConfig(ceiling=cfg["pitch"]["fmax"], **cfg["path"]) != PathConfig(ceiling=cfg["pitch"]["fmax"]):
            raise ValueError(f"the port's path costs are not the configuration's {cfg['path']}")

    # --- set-up: the pool, and every block once.
    pool = traffic.make_pool(c.mix, cfg, args.seed, pinned=pinned)
    prog = Program(pool, pcfg, dev)
    for i in range(len(pool)):
        prog.run(i)
    _sync(dev)
    peak = _peak(dev, reset=True)

    # --- the window.
    order = traffic.visits(len(pool), args.seed)
    setup_s = time.perf_counter() - T_START
    w = window(prog, order, args.seconds, c.mix["check_blocks"], traffic.rng_for(args.seed, 2))
    window_peak = _peak(dev)
    peak = max(peak, window_peak)
    if not w["latencies"]:
        print("benchmark: no block completed inside the window", file=sys.stderr)
        return None
    values = {
        "audio_s_per_s": w["audio_s"] / (w["last"] - w["start"]),
        "block_p95_ms": float(np.percentile(np.asarray(w["latencies"]) * 1e3, 95)),
        "peak_mem_gib": window_peak / 2**30,
        "setup_s": setup_s,
    }
    q = np.percentile(np.asarray(w["latencies"]) * 1e3, [0, 5, 50, 95, 100])
    print(f"window: {len(w['latencies'])} blocks in {w['last'] - w['start']!r} s, {w['attempted']} attempted; "
          f"set-up {setup_s!r} s; block ms min, p5, p50, p95, max {q.tolist()}", file=sys.stderr)
    by_rung = {}
    for i, t in zip(w["blocks"], w["latencies"]):
        by_rung.setdefault(pool[i].padded_frames, []).append(t * 1e3)
    for rung, ts in sorted(by_rung.items()):
        print(f"window: {len(ts)} blocks of {rung} frames, ms p50, p95, max "
              f"{np.percentile(ts, [50, 95, 100]).tolist()}", file=sys.stderr)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "count": c.chips}
    breakdown = None
    if args.trace:
        tr_order = list(itertools.islice(traffic.visits(len(pool), args.seed, stream=3), c.mix["trace_blocks"]))
        sites = trace.host_syncs(lambda: [prog.run(i) for i in tr_order])
        print(f"host syncs over {len(tr_order)} blocks: {len(sites)} at {sorted(set(sites))}", file=sys.stderr)
        acts, span_w, spans = trace.profile_blocks(lambda i, span: prog.run(i, span), tr_order)
        peak = max(peak, _peak(dev))
        t = trace.Trace(acts, span_w, spans, [pool[i] for i in tr_order], len(sites), len(tr_order), cfg,
                        trace.kernel_names(root / "benchmark" / "port_kernels.txt"))
        values = {}
        for m in c.per_layer:
            v = reader(m["name"], root)(t)
            if v is not None:
                values[m["name"]] = v
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        breakdown = trace.breakdown(t)
        print(f"traced {len(tr_order)} blocks: busy {t.busy_s()!r} s of {t.window_s!r} s, "
              f"{len(acts)} device activities", file=sys.stderr)
    device["memory_peak_bytes"] = int(peak)
    units = {m["name"]: m["unit"] for m in (c.per_layer if args.trace else c.end_to_end)}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}

    # --- the check, once the program's device memory is freed.
    del prog
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.numbers(w["kept"], pool, cfg, c.mix, args.seed, dev)
    correct, shown = check.verdict(numbers, c.limits)
    print(f"check: {len(w['kept'])} block(s), {numbers['frames_compared']} frames in "
          f"{time.perf_counter() - t_check!r} s; all numbers {json.dumps(numbers)}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": w["attempted"], "failed": 0, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    return result


if __name__ == "__main__":
    sys.exit(main())
