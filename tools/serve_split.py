#!/usr/bin/env python3
"""What a served batch changes in the features, and what end to end costs,
on one CUDA card.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/serve_split.py [--root DIR] [--runs 9]

1. MFCC stage by stage, one recording (tiles of the bundled recording,
   float32, at CLI_DEFAULT_44K and at 16 kHz 2048/512) analysed alone and
   as row 0 of a block as the server's dispatch frames it
   (`serve._MicroBatcher`: a zero-padded (B, S) block on the bucket
   ladder, frames past each recording's end zeroed), at the (B, Fp) shapes
   phase 11's requests take (`CASES`): the frames, the windowed frames, the
   rfft power spectrum, the filterbank products (`mfcc.mfcc`'s two
   matmuls) and the DCT, each stage fed the same rows alone (M = F) and
   inside the block (M = B * Fp), the values that differ in bits counted
   at each stage; and every key of `analyze` against the block's row.
   chip_smoke.py's phase 11 counts the served values that are not
   bit-equal to `analyze`; this says at which stage they part.
2. With --root DIR (another checkout, for instance the parent commit
   unpacked with `git archive` into a git-ignored directory): `analyze`
   end to end on chip_smoke.py's CLI, bench and flagship paths (126 tiles,
   float32), the median of --runs warm runs each ending in a device sync,
   each checkout in a new process (its own kernel build), in turns: this,
   other, other, this.

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "sample-two_vowels.wav"
TILES = 126
PATHS = ("CLI_DEFAULT_44K", "BENCH_44K", "FLAGSHIP_44K")


def apart(a, b) -> int:
    return int((a != b).sum())


def mfcc_stages(cfg, rec, B: int, Fp: int) -> dict:
    """Part 1 for one block shape: {stage: values apart} between `rec`
    (float32) alone and as row 0 of a (B, Fp) block whose other rows hold
    0.7 times it."""
    import numpy as np
    import torch

    from voxtpu_torch.device import constant
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.mfcc import _folded_bank, dct
    from voxtpu_torch.pipeline import analyze, analyze_batch_padded
    from voxtpu_torch.windows import hann

    dev = torch.device("cuda", 0)
    m = cfg.mfcc
    n, hop = cfg.frame_len, cfg.hop
    f0 = (len(rec) - n) // hop + 1
    block = np.zeros((B, (Fp - 1) * hop + n), np.float32)
    block[0, : len(rec)] = rec
    block[1:, : len(rec)] = 0.7 * rec
    lengths = torch.full((B,), len(rec), device=dev)
    alone = frame_signal(torch.as_tensor(rec, device=dev), n, hop)
    fb = frame_signal(torch.as_tensor(block, device=dev), n, hop)
    fb = (fb * (torch.arange(Fp, device=dev) < f0)[None, :, None].float()).reshape(-1, n)
    win = constant(hann, n, dtype=torch.float32, device=dev)
    wa, wb = alone * win, fb * win
    out = {"frames": apart(alone, fb[:f0]), "windowed": apart(wa, wb[:f0])}

    def power(x):
        s = torch.fft.rfft(x, dim=-1)
        return s.real.square() + s.imag.square()

    out["rfft power"] = apart(power(wa), power(wb)[:f0])
    pb = power(wb)
    same = pb[:f0].clone()  # from here on both sides take the same rows
    bank = (n, m.num_coeffs, m.freq_lo, m.freq_hi, cfg.sample_rate, m.exact)
    wp = constant(_folded_bank, 0, *bank, dtype=torch.float32, device=dev)
    wm = constant(_folded_bank, 1, *bank, dtype=torch.float32, device=dev)
    out["filterbank matmul (power)"] = apart(torch.matmul(same, wp), torch.matmul(pb, wp)[:f0])
    out["filterbank matmul (magnitude)"] = apart(torch.matmul(same.sqrt(), wm), torch.matmul(pb.sqrt(), wm)[:f0])
    loge = torch.log10(torch.clamp(torch.matmul(pb, wp) + torch.matmul(pb.sqrt(), wm), min=0.0)).clamp(min=1e-10)
    out["DCT matmul"] = apart(dct(loge[:f0].clone()), dct(loge)[:f0])
    row = {k: v[0, :f0] for k, v in analyze_batch_padded(torch.as_tensor(block, device=dev), lengths, cfg).items()}
    one_shot = analyze(torch.as_tensor(rec, device=dev), cfg)
    out["analyze vs block row"] = {k: apart(row[k], one_shot[k]) for k in sorted(one_shot) if apart(row[k], one_shot[k])}
    out["M alone, in the block; K"] = [f0, B * Fp, n // 2 + 1]
    return out


CASES = (  # (config, tiles, sample rate, (B, Fp) blocks): the shapes phase 11's requests take
    ("CLI_DEFAULT_44K", 3, 44100.0, ((1, 1024), (2, 1024), (4, 1024), (8, 1024))),
    ("CLI_DEFAULT_44K", 7, 44100.0, ((1, 2048), (2, 2048), (4, 2048))),
    ("16 kHz 2048/512", 4, 16000.0, ((1, 1024), (2, 1024))),
)


def mfcc_cases() -> dict:
    import numpy as np

    from voxtpu_torch.cli import build_analysis_config
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.pipeline import CLI_DEFAULT_44K

    one = np.asarray(read_wav(str(FIXTURE)).samples, np.float64)
    out = {}
    for name, tiles, rate, blocks in CASES:
        x = np.tile(one, tiles)
        if rate == 44100.0:
            cfg = CLI_DEFAULT_44K
        else:  # chip_smoke.py phase 11's 16 kHz request
            cfg = build_analysis_config(rate, frame_ms=128.0, hop_ms=32.0)
            x = np.interp(np.arange(0, len(x) * rate / 44100.0) * 44100.0 / rate, np.arange(len(x)), x)
        for B, Fp in blocks:
            out[f"{name}, {tiles} tiles, block ({B}, {Fp})"] = mfcc_stages(cfg, x.astype(np.float32), B, Fp)
    return out


def e2e(root: str, runs: int) -> dict:
    """Part 2, in a new process: `analyze` end to end on each path with
    root's voxtpu_torch, {path: median ms}."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from voxtpu_torch import pipeline
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import kernels

    kernels.library()
    x = torch.as_tensor(np.tile(np.asarray(read_wav(str(FIXTURE)).samples, np.float64), TILES), device="cuda")
    x = x.float()
    out = {}
    for name in PATHS:
        cfg = getattr(pipeline, name)
        pipeline.analyze(x, cfg)
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            pipeline.analyze(x, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="another checkout, timed end to end in turns with this one")
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--e2e", help=argparse.SUPPRESS)  # the child process of part 2
    args = ap.parse_args()
    if args.e2e:
        print(json.dumps(e2e(args.e2e, args.runs)))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: serve_split.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "mfcc_stages": mfcc_cases()}
    for case, stages in result["mfcc_stages"].items():
        print(f"MFCC, one recording alone vs row 0 of a block, values apart at each stage; {case} [{card}]:")
        print("  " + "; ".join(f"{k} {v}" for k, v in stages.items()))
    if args.root:
        turns = []
        for root in (ROOT, Path(args.root).resolve(), Path(args.root).resolve(), ROOT):
            proc = subprocess.run([sys.executable, __file__, "--e2e", str(root), "--runs", str(args.runs)],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode:
                raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            turns.append({"root": str(root), "ms": json.loads(proc.stdout.strip().splitlines()[-1])})
            print(f"analyze end to end, {root}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in turns[-1]["ms"].items())
                  + f" [{card}]")
        result["e2e_turns"] = turns
    print(json.dumps(result))


if __name__ == "__main__":
    main()
