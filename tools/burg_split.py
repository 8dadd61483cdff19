#!/usr/bin/env python3
"""Kernel B's times and the card's rates that bound it, on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does, and the probes of tools/burg_rates.cu
with chip_smoke.py's `rate_probes_build` into build/burg_rates/):

    python3 tools/burg_split.py [--root DIR] [--paths cli,bench,flagship] [--dtypes f32,f64]
                                [--lengths N,...] [--no-rates] [--layouts] [--clusters C,...]

For each path (chip_smoke.py's CLI, bench and flagship configurations over
its 126 tiles of the bundled recording) and dtype it builds kernel B's
arguments as the path passes them (the Hann-windowed frames and the Burg
order, as `chip_smoke.kernel_inputs` does) and times `burg` with CUDA
events (`chip_smoke.event_ms`, mean of --runs). With --layouts, and where
the checkout's `ops.burg` has `ROWS` (its three layouts), it also launches
the kernel (uncounted, `burg._launch`) with the other layouts where they
fit at those shapes (the rows in shared or in device memory where the
rule picks registers), beside the one `launch_config` picks. --lengths
also times B, order 13, on 2,048 noisy frames of each length
(`chip_smoke.burg_large_frames`), for frames longer than the paths'.
--clusters also times the cluster layout at each of those block counts
(the fewest whole warps whose threads hold a block's share, where that
fits a block), beside the one the rule picks, and counts the frames whose
coefficients or status differ in bits from the rule's launch.

The rates (skipped with --no-rates; `chip_smoke.probe_rates`): float ->
double conversions, float64 fused multiply-adds, 32-bit shared-memory
loads, and steps of one conversion and one FMA on independent chains,
each per clock and SM, from the probes' time and the SM clock that
thread 0 of block 0 saw (clock64 against the global timer).

--root imports voxtpu_torch from another checkout, for instance the parent
commit unpacked with `git archive` into a git-ignored directory, so that
two versions are timed on one card in one call (run them in turns); that
checkout's kernels build into its own build/. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="checkout whose voxtpu_torch is timed")
    ap.add_argument("--paths", default="cli,bench,flagship")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--lengths", default="", help="frame lengths to time beside the paths' (comma-separated)")
    ap.add_argument("--runs", type=int, default=5, help="timed launches after a warm-up")
    ap.add_argument("--no-rates", action="store_true", help="skip the rate probes")
    ap.add_argument("--layouts", action="store_true", help="also time the other layouts where they fit")
    ap.add_argument("--clusters", default="", help="cluster sizes to time beside the rule's (comma-separated)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: burg_split.py runs on the card only")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import burg, kernels
    from voxtpu_torch.pipeline import BENCH_44K, CLI_DEFAULT_44K, FLAGSHIP_44K

    if Path(burg.__file__).resolve().parents[2] != root:
        raise SystemExit(f"voxtpu_torch imported from {burg.__file__}, not from {root}")
    kernels.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with_layouts = args.layouts and hasattr(burg, "ROWS")
    print(f"{card}; voxtpu_torch from {root}; layouts: {with_layouts}", flush=True)
    result = {"card": card, "root": str(root), "rows": []}
    if not args.no_rates:
        cmd, lib = cs.rate_probes_build(kernels.find_nvcc())
        subprocess.run(cmd, check=True)
        result["rates"] = cs.probe_rates(lib, cs.RATE_PROBES, card)
    dev = torch.device("cuda", 0)
    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig64 = torch.as_tensor(np.tile(one, cs.TILES), device=dev)
    cfgs = {"cli": CLI_DEFAULT_44K, "bench": BENCH_44K, "flagship": FLAGSHIP_44K}
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    cases = [(path, dname) for path in args.paths.split(",") for dname in args.dtypes.split(",")]
    cases += [(int(n), dname) for n in args.lengths.split(",") if n for dname in args.dtypes.split(",")]
    for path, dname in cases:
        dt = dtypes[dname]
        if isinstance(path, int):
            x, p = cs.burg_large_frames(path, 2048, dt, dev), 13
        else:
            cfg = cfgs[path]
            x = cs.hann_windowed(frame_signal(sig64.to(dt), cfg.frame_len, cfg.hop)).contiguous()
            p = cfg.formant.n_coeffs
        B, N = x.shape
        chosen = burg.launch_config(N, dt) if with_layouts else None
        configs = [chosen]
        if with_layouts:
            others = (burg.layout(N, dt, rows) for rows in burg.ROWS if rows != chosen.rows)
            configs += [c for c in others if c is not None]
        for blocks in (int(c) for c in args.clusters.split(",") if c):
            config = cluster_config(burg, N, dt, blocks)
            if config is not None and config not in configs:
                configs.append(config)
        want = burg._launch(x, p, chosen) if args.clusters else None
        for config in configs:
            ms = cs.event_ms(lambda: burg.burg(x, p) if config is chosen else burg._launch(x, p, config),
                             runs=args.runs)
            row = {"path": path, "dtype": dname, "ms": ms, "frames": B, "n": N, "order": p}
            text = ""
            if with_layouts:
                row.update(config._asdict(), chosen_by_rule=config is chosen)
                text = f", {config}{' (the rule)' if config is chosen else ''}"
            if want is not None:
                got = burg._launch(x, p, config)
                row["frames_apart"] = int(((cs.bits(got[0]) != cs.bits(want[0])).any(dim=-1)
                                           | (got[1] != want[1])).sum())
                text += f", {row['frames_apart']} frames apart in bits from the rule's"
            print(f"burg, {path}, {dname}: {ms:.3f} ms ({B} frames of {N}, order {p}{text}) [{card}]", flush=True)
            result["rows"].append(row)
        del x
    print(json.dumps(result))


def cluster_config(burg, n: int, dt, blocks: int):
    """The cluster layout over `blocks` blocks at the fewest whole warps whose
    threads hold a block's share of the pairs, or None where that does not
    fit a block."""
    threads = burg._threads(-(-(n - 1) // blocks) + 1, burg._SHARED_WIDTH)
    fits = burg._fits(n, dt.itemsize, "cluster", threads, blocks)
    return burg.BurgConfig("cluster", threads, burg._SHARED_WIDTH, blocks) if fits else None


if __name__ == "__main__":
    main()
