#!/usr/bin/env python3
"""Kernel C's times, registers and Laguerre iteration in SASS, on one CUDA
card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/roots_split.py [--root DIR] [--paths cli,bench,flagship] [--dtypes f32,f64] [--runs 5]

For each path (chip_smoke.py's CLI, bench and flagship configurations over
its 126 tiles of the bundled recording) and dtype it builds kernel C's
arguments as the formant stage passes them (`chip_smoke.roots_inputs`: the
Burg coefficients of the Hann-windowed frames reversed under a top
coefficient of 1) and times `find_roots` with CUDA events
(`chip_smoke.event_ms`, mean of --runs), beside its bound
(`chip_smoke.roots_bound`). It prints each `roots_kernel` instantiation's
registers, stack frame and spills from the build's report and, where the
toolkit has cuobjdump, the SASS instructions of one Laguerre iteration
(`chip_smoke.laguerre_loop`) and the issue floor they set at each path's
shapes (`chip_smoke.roots_issue_floor`).

--root DIR also loads the kernel library of another checkout (its
voxtpu_torch/ops/kernels.py, which builds that checkout's sources into its
own build/), for instance the parent commit unpacked with `git archive`
into a git-ignored directory. The two kernels then run in turns (this,
other, other, this) on the same inputs, and the elements where their roots,
counts or statuses differ in bits are counted. The last line is one JSON
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


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launcher(kernels):
    """Kernel C of a checkout's kernel library, called as the wrapper calls
    it: (c_re, c_im) -> (roots_re, roots_im, count, status)."""
    import torch

    def run(c_re, c_im):
        B, N = c_re.shape
        r_re, r_im = torch.empty_like(c_re), torch.empty_like(c_re)
        count = torch.empty((B,), dtype=torch.int32, device=c_re.device)
        status = torch.empty_like(count)
        kernels.launch("vt_roots", c_re.dtype, c_re, c_im, r_re, r_im, count, status, B, N)
        return r_re, r_im, count, status

    return run


def build_report(cs, kernels, label: str) -> dict:
    """Each roots_kernel's registers, stack frame and spills, and its
    Laguerre iteration in SASS, of one checkout's library."""
    lib = kernels.library_path()
    log = lib.with_suffix(".log").read_text()
    regs = cs.kernel_registers(log, "roots_kernel")
    frames = cs.stack_frames(log, "roots_kernel")
    loops = {name: cs.laguerre_loop(ins) for name, ins in cs.sass(lib, "roots_kernel").items()}
    report = {}
    for name in sorted(set(regs) | set(frames) | set(loops)):
        report[name] = {"registers": regs.get(name), "stack_spill": frames.get(name), "laguerre_sass": loops.get(name)}
        print(f"{label} {name}: {regs.get(name)} registers, stack frame / spill stores / spill loads "
              f"{frames.get(name)} bytes; one Laguerre iteration in SASS: {loops.get(name)}", flush=True)
    return report


def nonfinite_rows(dt) -> tuple:
    """(c_re, c_im): (6, 14) random rows with NaN, infinite and huge
    coefficients, for the bit comparison of two kernels only."""
    rng = np.random.default_rng(0)
    re = rng.uniform(-1, 1, (6, 14))
    im = np.zeros_like(re)
    re[0, 3] = np.nan
    re[1, 5] = np.inf
    re[2, 13] = -np.inf
    im[3, 0] = np.nan
    re[4, 7], im[4, 7] = np.inf, np.nan
    re[5] = 1e30
    return np.ascontiguousarray(re, dt), np.ascontiguousarray(im, dt)


def differ(a, b, bits) -> dict:
    """Elements of two kernels' (roots_re, roots_im, count, status) that differ in bits."""
    return {name: int((bits(x) != bits(y)).sum()) if x.is_floating_point() else int((x != y).sum())
            for name, x, y in zip(("roots_re", "roots_im", "count", "status"), a, b)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None, help="another checkout whose kernel C runs beside this one")
    ap.add_argument("--paths", default="cli,bench,flagship")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--runs", type=int, default=5, help="timed launches after a warm-up")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: roots_split.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import find_roots, kernels
    from voxtpu_torch.pipeline import BENCH_44K, CLI_DEFAULT_44K, FLAGSHIP_44K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels.library()
    other = other_kernels = None
    if args.root is not None:
        root = args.root.resolve()
        other_kernels = load_module("other_kernels", root / "voxtpu_torch" / "ops" / "kernels.py")
        other_kernels.library()
        other = launcher(other_kernels)
    print(f"{card}; this checkout {ROOT}; other {args.root}; {sms} SMs", flush=True)
    result = {"card": card, "root": str(ROOT), "other": str(args.root), "build": {}, "rows": []}
    result["build"]["this"] = build_report(cs, kernels, "this")
    if other is not None:
        result["build"]["other"] = build_report(cs, other_kernels, "other")

    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig64 = torch.as_tensor(np.tile(one, cs.TILES), device=dev)
    cfgs = {"cli": CLI_DEFAULT_44K, "bench": BENCH_44K, "flagship": FLAGSHIP_44K}
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    loops = {}  # (checkout, N): cs.roots_loops
    for path in args.paths.split(","):
        cfg = cfgs[path]
        for dname in args.dtypes.split(","):
            frames = frame_signal(sig64.to(dtypes[dname]), cfg.frame_len, cfg.hop)
            c_re, c_im = cs.roots_inputs(cs.hann_windowed(frames), cfg.formant.n_coeffs)
            del frames
            B, N = c_re.shape
            bound_ms, bound_by = cs.roots_bound(c_re)
            row = {"path": path, "dtype": dname, "frames": B, "n": N, "bound_ms": bound_ms, "bound_by": bound_by}
            row["issue_floor_ms"] = {}
            for k, kern in (("this", kernels), ("other", other_kernels)):
                if kern is not None and (k, N) not in loops:
                    loops[k, N] = cs.roots_loops(kern.library_path(), N)
                loop = loops[k, N][dname] if kern is not None else None
                if loop:
                    row["issue_floor_ms"][k] = cs.roots_issue_floor(c_re, c_im, loop["instructions"], sms,
                                                                   loop["float64"] if dname == "f64" else 0)

            def mine():
                return find_roots.find_roots(c_re, c_im)

            if other is None:
                row["ms"] = cs.event_ms(mine, runs=args.runs)
                text = f"{row['ms']:.4f} ms"
            else:
                times = [cs.event_ms(fn, runs=args.runs) for fn in (mine, lambda: other(c_re, c_im))]
                times += [cs.event_ms(fn, runs=args.runs) for fn in (lambda: other(c_re, c_im), mine)]
                row["ms"], row["other_ms"] = [times[0], times[3]], [times[1], times[2]]
                diff = differ(mine(), other(c_re, c_im), cs.bits)
                row["differ_in_bits"] = diff
                text = (f"this {times[0]:.4f}, {times[3]:.4f} ms; other {times[1]:.4f}, {times[2]:.4f} ms; "
                        f"elements that differ in bits {diff}")
            floors = "; ".join(f"issue floor ({k}) even {e:.4f}, busiest scheduler {b:.4f} ms"
                               for k, (e, b) in row["issue_floor_ms"].items())
            print(f"find_roots, {path}, {dname}: {text} ({B} x {N}); bound {bound_ms:.4f} ms by {bound_by}; "
                  f"{floors} [{card}]", flush=True)
            result["rows"].append(row)
            del c_re, c_im
    if other is not None:
        # The edge rows and rows with NaN and infinite coefficients, in both dtypes.
        for dname, npdt in (("f32", np.float32), ("f64", np.float64)):
            cases = [*cs.roots_edge_cases(npdt), ("non-finite", *nonfinite_rows(npdt))]
            for name, re_, im_ in cases:
                c = (torch.as_tensor(re_, device=dev), torch.as_tensor(im_, device=dev))
                diff = differ(find_roots.find_roots(*c), other(*c), cs.bits)
                result["rows"].append({"case": name, "dtype": dname, "differ_in_bits": diff})
                print(f"find_roots, {name} rows, {dname}: elements that differ in bits {diff}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
