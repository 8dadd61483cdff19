#!/usr/bin/env python3
"""Kernel A's time split between one evaluation a candidate and Brent, on
one CUDA card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/refine_split.py [--root DIR] [--paths cli,bench,flagship] [--dtypes f32,f64]

For each path (chip_smoke.py's CLI, bench and flagship configurations over
its 126 tiles of the bundled recording) and dtype it builds kernel A's
arguments as the path passes them (`chip_smoke.refine_inputs`) and times
`refine` with CUDA events (`chip_smoke.event_ms`): with the path's Brent
(iters=60) and in the evaluation-only mode (iters=0, one evaluation a
candidate). Beside each time: the kernel's `stats` (evaluations and
tap-sides of the live candidates, the most Brent iterations a candidate
ran), where the checkout's `refine` takes them.

--root imports voxtpu_torch from another checkout, for instance the parent
commit unpacked with `git archive` into a git-ignored directory, so that
two versions are timed on one card in one call (run them in turns); that
checkout's kernels build into its own build/. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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
    ap.add_argument("--runs", type=int, default=5, help="timed launches after a warm-up")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: refine_split.py runs on the card only")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import kernels, refine
    from voxtpu_torch.pipeline import BENCH_44K, CLI_DEFAULT_44K, FLAGSHIP_44K

    if Path(refine.__file__).resolve().parents[2] != root:
        raise SystemExit(f"voxtpu_torch imported from {refine.__file__}, not from {root}")
    with_stats = "stats" in inspect.signature(refine.refine).parameters
    kernels.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; voxtpu_torch from {root}; kernel stats: {with_stats}", flush=True)
    dev = torch.device("cuda", 0)
    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig64 = torch.as_tensor(np.tile(one, cs.TILES), device=dev)
    cfgs = {"cli": CLI_DEFAULT_44K, "bench": BENCH_44K, "flagship": FLAGSHIP_44K}
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    result = {"card": card, "root": str(root), "rows": []}
    for path in args.paths.split(","):
        cfg = cfgs[path]
        for dname in args.dtypes.split(","):
            frames = frame_signal(sig64.to(dtypes[dname]), cfg.frame_len, cfg.hop)
            windowed, pre_args = cs.pitch_pre_inputs(frames, cfg)
            rargs = cs.refine_inputs(windowed, pre_args, cfg)
            del frames, windowed, pre_args
            B, C = rargs[1].shape
            live = int(rargs[2].sum())
            for iters in (60, 0):
                ms = cs.event_ms(lambda: refine.refine(*rargs, iters=iters), runs=args.runs)
                row = {"path": path, "dtype": dname, "iters": iters, "ms": ms, "frames": B, "candidates": C,
                       "live": live}
                text = ""
                if with_stats:
                    st = torch.empty(3, dtype=torch.int64, device=dev)
                    refine.refine(*rargs, iters=iters, stats=st)
                    evals, taps, most = (int(v) for v in st.cpu())
                    row.update(evals=evals, tap_sides=taps, most_iters=most)
                    text = (f"; {evals / max(live, 1):.3f} evaluations a live candidate, {taps / B:.1f} tap-sides a "
                            f"frame, at most {most} Brent iterations")
                print(f"refine, {path}, {dname}, iters={iters}: {ms:.3f} ms ({B} frames x {C} candidates, {live} live)"
                      f"{text} [{card}]", flush=True)
                result["rows"].append(row)
            del rargs
    print(json.dumps(result))


if __name__ == "__main__":
    main()
