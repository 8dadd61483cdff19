#!/usr/bin/env python3
"""Kernel P's times by Horner-pass count, beside its bounds, on one CUDA
card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/polish_split.py [--root DIR] [--paths cli,bench,flagship] [--dtypes f32,f64] [--runs 20]

For each path (chip_smoke.py's CLI, bench and flagship configurations over
its 126 tiles of the bundled recording) and dtype it builds kernel P's
arguments as the formant stage passes them (`chip_smoke.kernel_inputs`:
the reversed monic Burg polynomials and kernel C's roots of them) and
times `polish_roots` with CUDA events (`chip_smoke.event_ms`, mean of
--runs) at 0, 1 and 2 Newton iterations, beside its bound
(`chip_smoke.polish_bound`: 1 + iters Horner passes a live slot) and the
bound of the 1 + 2 iters passes the plain version makes. It prints each
`polish_kernel` instantiation's registers, stack frame and spills from the
build's report.

--root DIR also loads the kernel library of another checkout (its
voxtpu_torch/ops/kernels.py, which builds that checkout's sources into its
own build/), for instance the parent commit unpacked with `git archive`
into a git-ignored directory. The two kernels then run in turns (this,
other, other, this) on the same inputs, and the elements whose outputs
differ in bits are counted, also on `chip_smoke.polish_edge_cases`. The
last line is one JSON object.
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


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launcher(kernels):
    """Kernel P of a checkout's kernel library, called as the wrapper calls
    it: (c_re, c_im, z_re, z_im, iters) -> (re, im)."""
    import torch

    def run(c_re, c_im, z_re, z_im, iters=2):
        F, N = c_re.shape
        out_re, out_im = torch.empty_like(z_re), torch.empty_like(z_im)
        kernels.launch("vt_polish", c_re.dtype, c_re, c_im, z_re, z_im, out_re, out_im, F, N, iters, 0.25)
        return out_re, out_im

    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None, help="another checkout whose kernel P runs beside this one")
    ap.add_argument("--paths", default="cli,bench,flagship")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--runs", type=int, default=20, help="timed launches after a warm-up")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: polish_split.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import kernels
    from voxtpu_torch.pipeline import BENCH_44K, CLI_DEFAULT_44K, FLAGSHIP_44K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kernels.library()
    mine = launcher(kernels)
    other = None
    result = {"card": card, "root": str(ROOT), "other": str(args.root), "build": {}, "rows": []}
    builds = [("this", kernels)]
    if args.root is not None:
        other_kernels = load_module("other_kernels", args.root.resolve() / "voxtpu_torch" / "ops" / "kernels.py")
        other_kernels.library()
        other = launcher(other_kernels)
        builds.append(("other", other_kernels))
    for label, kern in builds:
        log = kern.library_path().with_suffix(".log").read_text()
        regs, frames = cs.kernel_registers(log, "polish_kernel"), cs.stack_frames(log, "polish_kernel")
        result["build"][label] = {name: {"registers": regs.get(name), "stack_spill": frames.get(name)}
                                  for name in sorted(set(regs) | set(frames))}
        for name, v in result["build"][label].items():
            print(f"{label} {name}: {v['registers']} registers, stack frame / spill stores / spill loads "
                  f"{v['stack_spill']} bytes", flush=True)
    print(f"{card}; this checkout {ROOT}; other {args.root}", flush=True)

    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig64 = torch.as_tensor(np.tile(one, cs.TILES), device=dev)
    cfgs = {"cli": CLI_DEFAULT_44K, "bench": BENCH_44K, "flagship": FLAGSHIP_44K}
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    for path in args.paths.split(","):
        cfg = cfgs[path]
        for dname in args.dtypes.split(","):
            frames = frame_signal(sig64.to(dtypes[dname]), cfg.frame_len, cfg.hop)
            pa = cs.kernel_inputs(frames, cfg)[0]["polish"]
            del frames
            F, N = pa[0].shape
            row = {"path": path, "dtype": dname, "frames": F, "n": N,
                   "live": int(((pa[2] != 0) | (pa[3] != 0)).sum()), "ms": {}, "other_ms": {}}
            for iters in (0, 1, 2):
                if other is None:
                    row["ms"][iters] = cs.event_ms(lambda: mine(*pa, iters), runs=args.runs)
                else:
                    times = [cs.event_ms(lambda: fn(*pa, iters), runs=args.runs) for fn in (mine, other, other, mine)]
                    row["ms"][iters], row["other_ms"][iters] = [times[0], times[3]], [times[1], times[2]]
            row["bound_ms"], row["bound_by"] = cs.polish_bound(pa)
            row["bound_plain_passes_ms"] = cs.polish_bound(pa, passes_per_iter=2)[0]
            text = "; ".join(f"iters {it}: this {row['ms'][it]}" + (f", other {row['other_ms'][it]}" if other else "")
                             for it in (0, 1, 2))
            if other is not None:
                cases = (("path rows", pa), ("edge rows", cs.polish_edge_cases(*pa)))
                row["differ_in_bits"] = {
                    case: sum(int((cs.bits(x) != cs.bits(y)).sum()) for x, y in zip(mine(*a), other(*a)))
                    for case, a in cases}
                text += f"; elements that differ in bits {row['differ_in_bits']}"
            print(f"polish, {path}, {dname} ({F} x {N}, {row['live']} live slots): {text} ms; bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']} (1 + iters passes), "
                  f"{row['bound_plain_passes_ms']:.4f} at 1 + 2 iters [{card}]", flush=True)
            result["rows"].append(row)
            del pa
    print(json.dumps(result))


if __name__ == "__main__":
    main()
