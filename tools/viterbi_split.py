#!/usr/bin/env python3
"""Kernel F's times, its two device kernels apart, and its chain's clocks,
on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/viterbi_split.py [--root DIR] [--paths bench_viterbi,flagship_viterbi,corpus_viterbi]
                                   [--dtypes f32,f64] [--runs 3] [--chunks-mib 2,4,8,16,64] [--sass FILE]

For each path (chip_smoke.py's bench and flagship configurations with the
Viterbi path search over its 126 tiles of the bundled recording, and its
16-recording corpus block) and dtype it builds the DP inputs as
`viterbi.pitch_path` does from the path's own candidates
(`chip_smoke.bench_kernel_inputs`) and times `viterbi_path` with CUDA
events (`chip_smoke.event_ms`, mean of --runs), the pre-pass
(`viterbi_costs`) and the chain (`viterbi_chain`) apart from one
torch.profiler trace, and the chain floor: (F - 1) steps at the clocks a
step takes outside its wait for a record, counted by thread 0 of
recording 0's chain (the probe instantiation, through `viterbi._launch`).
--chunks-mib M1,M2,... also times it in chunks of frame steps whose
records take at most each of these MiB (at least one step a chunk, each
chunk's pre-pass then its chain, as `launch_config` picks them at 16
MiB), in two rounds, ascending then descending, and checks that every
chunking gives the same path. It prints each instantiation's registers, stack frame,
spills and shared memory from the build's report.

--root DIR also loads the kernel library of another checkout (its
voxtpu_torch/ops/kernels.py, which builds that checkout's sources into its
own build/), for instance the parent commit unpacked with `git archive`
into a git-ignored directory. The two kernels then run in turns (this,
other, other, this) on the same inputs, and the frames whose paths differ
are counted. The last line is one JSON object.
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


def other_launcher(kernels, root: Path):
    """Kernel F of another checkout's kernel library, called as its wrapper
    calls it: (local, freq, voiced, ojc, vuc) -> path; the one-kernel
    design's launcher (signature pppppiiidd, before the cost pre-pass), or this
    design's, with its records in chunks and the carried scores."""
    import torch

    records = kernels._SIGNATURES["vt_viterbi"] != "pppppiiidd"
    vmod = load_module("other_viterbi", root / "voxtpu_torch" / "ops" / "viterbi.py") if records else None

    def run(local, freq, voiced, ojc, vuc):
        B, F, C = local.shape
        bp = torch.empty((B, F, C), dtype=torch.int32, device=local.device)
        path = torch.empty((B, F), dtype=torch.int32, device=local.device)
        if records:
            cfg = vmod.launch_config(B, F, C, local.dtype)
            scratch = torch.empty((cfg.scratch,), dtype=torch.uint8, device=local.device)
            carry = torch.empty((B, C), dtype=local.dtype, device=local.device)
            kernels.launch("vt_viterbi", local.dtype, local, freq, voiced, scratch, carry, bp, path, None, B, F, C,
                           cfg.record, cfg.steps, float(ojc), float(vuc))
        else:
            kernels.launch("vt_viterbi", local.dtype, local, freq, voiced, bp, path, B, F, C, float(ojc), float(vuc))
        return path

    return run


def kernel_split(cs, fn, names) -> dict | None:
    """{name: device ms} of the kernels whose profiler names hold `names`
    in one traced call of fn (`chip_smoke.trace_once`), taken again while
    a trace lacks one of them, at most chip_smoke.PROFILE_TRACES in all;
    None when none held them all (a trace of one call of F came back
    without device activities in chip_smoke.py's phase 10)."""
    for _ in range(cs.PROFILE_TRACES):
        try:
            trace = cs.trace_once(fn)
        except AssertionError:
            continue
        split = {act: [(c, us) for name, (c, us) in trace["by_name"].items() if act in name] for act in names}
        if all(split.values()):
            return {act: sum(us for _c, us in v) / 1e3 for act, v in split.items()}
    return None


def chunk_sweep(cs, viterbi, b3, ojc, vuc, mibs: str, runs: int) -> list[dict]:
    """F on (B, F, C) inputs in chunks of records of at most each of `mibs`
    MiB: [{steps, mib, ms: [ascending round, descending round]}]; raises
    if a chunking changes the path."""
    import torch

    B, F, C = b3[0].shape
    record = viterbi.launch_config(B, F, C, b3[0].dtype).record
    steps = sorted({min(F - 1, max(1, (int(m) << 20) // (B * record))) for m in mibs.split(",")})
    want = viterbi._launch(*b3, ojc, vuc, steps=F - 1)
    times: dict[int, list[float]] = {}
    for order in (steps, steps[::-1]):
        for k in order:
            times.setdefault(k, []).append(cs.event_ms(lambda: viterbi._launch(*b3, ojc, vuc, steps=k), runs=runs))
    for k in steps:
        if not torch.equal(viterbi._launch(*b3, ojc, vuc, steps=k), want):
            raise AssertionError(f"viterbi: chunks of {k} steps change the path")
    return [{"steps": k, "mib": B * k * record / 2**20, "ms": times[k]} for k in steps]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None, help="another checkout whose kernel F runs beside this one")
    ap.add_argument("--paths", default="bench_viterbi,flagship_viterbi,corpus_viterbi")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--runs", type=int, default=3, help="timed calls after a warm-up")
    ap.add_argument("--chunks-mib", default=None, help="also time F in chunks of records of at most these MiB")
    ap.add_argument("--sass", type=Path, default=None, help="write the chain kernels' SASS (cuobjdump) to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: viterbi_split.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = cs
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import kernels, viterbi
    from voxtpu_torch.pipeline import BENCH_44K, FLAGSHIP_44K, analyze, analyze_batch_padded

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kernels.library()
    log = kernels.library_path().with_suffix(".log").read_text()
    result = {"card": card, "root": str(ROOT), "other": str(args.root), "rows": [], "build": {}}
    for kernel in ("viterbi_costs", "viterbi_chain"):
        regs, frames = cs.kernel_registers(log, kernel), cs.stack_frames(log, kernel)
        for name in sorted(regs):
            result["build"][name] = {"registers": regs[name], "stack_spill": frames.get(name)}
            print(f"{name}: {regs[name]} registers, stack frame / spill stores / spill loads {frames.get(name)} "
                  f"bytes", flush=True)
    if args.sass is not None:
        funcs = cs.sass(kernels.library_path(), "viterbi_chain")
        args.sass.write_text("".join(f"{name}\n" + "".join(f"  {addr:05x} {ins}\n" for addr, _op, ins in body)
                                     for name, body in funcs.items()))
    other = None
    if args.root is not None:
        other_kernels = load_module("other_kernels", args.root.resolve() / "voxtpu_torch" / "ops" / "kernels.py")
        other_kernels.library()
        other = other_launcher(other_kernels, args.root.resolve())
    print(f"{card}; this checkout {ROOT}; other {args.root}", flush=True)

    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig64 = torch.as_tensor(np.tile(one, cs.TILES), device=dev)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    for path in args.paths.split(","):
        for dname in args.dtypes.split(","):
            dt = dtypes[dname]
            if path == "corpus_viterbi":
                cfg = cs.with_viterbi(BENCH_44K)
                _, lengths, block = cs.corpus_block(one, cfg.sample_rate)
                x = torch.as_tensor(block, device=dev).to(dt)
                out = analyze_batch_padded(x, lengths, cfg)
                frames = frame_signal(x, cfg.frame_len, cfg.hop)
            else:
                cfg = cs.with_viterbi(BENCH_44K if path == "bench_viterbi" else FLAGSHIP_44K)
                x = sig64.to(dt)
                out = analyze(x, cfg)
                frames = frame_signal(x, cfg.frame_len, cfg.hop)
            va = cs.bench_kernel_inputs(frames, out, cfg)["viterbi"]
            del frames, out
            local, fs, voiced, ojc, vuc = va
            shape = tuple(local.shape)
            Fv = shape[-2]

            def mine():
                return viterbi.viterbi_path(*va)

            b3 = [t if t.dim() == 3 else t[None] for t in (local, fs, voiced)]
            row = {"path": path, "dtype": dname, "shape": shape}
            if other is None:
                row["ms"] = cs.event_ms(mine, runs=args.runs)
                text = f"{row['ms']:.3f} ms"
            else:

                def theirs():
                    return other(*b3, ojc, vuc)

                times = [cs.event_ms(fn, runs=args.runs) for fn in (mine, theirs, theirs, mine)]
                row["ms"], row["other_ms"] = [times[0], times[3]], [times[1], times[2]]
                row["frames_apart"] = int((mine().reshape(-1) != theirs().reshape(-1)).sum())
                text = (f"this {times[0]:.3f}, {times[3]:.3f} ms; other {times[1]:.3f}, {times[2]:.3f} ms; "
                        f"{row['frames_apart']} frames apart")
            if args.chunks_mib is not None:
                row["chunks"] = chunk_sweep(cs, viterbi, b3, ojc, vuc, args.chunks_mib, args.runs)
                text += "; in chunks: " + ", ".join(
                    f"{c['steps']} steps ({c['mib']:.2f} MiB) {c['ms'][0]:.3f}, {c['ms'][1]:.3f} ms"
                    for c in row["chunks"])
            row["kernels_ms"] = kernel_split(cs, mine, ("viterbi_costs", "viterbi_chain"))
            clocks = torch.zeros(8, dtype=torch.int64, device=dev)
            viterbi._launch(*b3, ojc, vuc, stamps=clocks)
            loop, wait, steps, ns, *parts = (int(v) for v in clocks.cpu())
            ghz = loop / ns if ns else float("nan")
            per_step = (loop - wait) / max(steps, 1)
            row.update(step_clocks=loop / max(steps, 1), wait_clocks=wait / max(steps, 1), sm_ghz=ghz,
                       part_clocks=dict(zip(("argmax", "combine", "stores", "barrier"),
                                            (p / max(steps, 1) for p in parts))),
                       chain_floor_ms=(Fv - 1) * per_step / ghz / 1e6,
                       config=viterbi.launch_config(*(shape if len(shape) == 3 else (1, *shape)), dt)._asdict())
            split = "not traced" if row["kernels_ms"] is None else ", ".join(
                f"{name} {ms:.3f} ms" for name, ms in row["kernels_ms"].items())
            print(f"viterbi, {path}, {dname}: {text} ({' x '.join(map(str, shape))}); traced {split}; chain "
                  f"{row['step_clocks']:.1f} clocks a step, {row['wait_clocks']:.1f} of them waiting for a record, "
                  f"{', '.join(f'{k} {v:.1f}' for k, v in row['part_clocks'].items())}, "
                  f"at {ghz:.3f} GHz: chain floor {row['chain_floor_ms']:.3f} ms; {row['config']} [{card}]",
                  flush=True)
            result["rows"].append(row)
            del va, local, fs, voiced
    print(json.dumps(result))


if __name__ == "__main__":
    main()
