#!/usr/bin/env python3
"""How often a torch.profiler trace of one path row loses or gains device
activities at the edges of its active step, with and without the idle pads
that chip_smoke.py's `profile_path` puts around each traced run.

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels as chip_smoke.py does):

    python3 tools/trace_window.py [--traces 15]

For each row (corpus_viterbi and bench before kernel P, corpus after it,
float32, the inputs of chip_smoke.py's phases 6 and 7) it takes `--traces`
traces with pads of 0 s and as many with `chip_smoke.PROFILE_PAD_S`, and
prints per pad the traces whose kernels (chip_smoke.TRACED_ACTIVITIES) do
not appear exactly as often as a counted run launched them or whose
device-activity count differs from the row's most common one, each with
the activity names whose counts differ from a usual trace. The last line
is the same as one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=15, help="traces per row and pad")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: trace_window.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import burg, ct_fused, find_roots, formant_scan, kernels, pitch_pre, polish, refine, viterbi
    from voxtpu_torch.pipeline import BENCH_44K, analyze, analyze_batch_padded

    wrappers = {
        "refine": refine.refine, "burg": burg.burg, "find_roots": find_roots.find_roots,
        "formant_scan": formant_scan.formant_scan, "ct_fused": ct_fused.ct_fused_power_ac,
        "viterbi": viterbi.viterbi_path, "pitch_pre": pitch_pre.pitch_pre, "polish": polish.polish_roots,
    }
    kernels.build()
    kernels.library()
    dev = torch.device("cuda")
    sr = BENCH_44K.sample_rate
    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig32 = torch.as_tensor(np.tile(one, cs.TILES), device=dev).float()
    _recs, lengths, block = cs.corpus_block(one, sr)
    block32 = torch.as_tensor(block, device=dev).float()
    bcfg, bvcfg = BENCH_44K, cs.with_viterbi(BENCH_44K)
    rows = {  # label: (run, before P)
        "corpus_viterbi before P": (lambda: analyze_batch_padded(block32, lengths, bvcfg), True),
        "bench before P": (lambda: analyze(sig32, bcfg), True),
        "corpus": (lambda: analyze_batch_padded(block32, lengths, bcfg), False),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    pad_s = cs.PROFILE_PAD_S
    result = {"card": card, "traces": args.traces, "pad_s": pad_s, "rows": {}}
    t0 = time.perf_counter()
    for label, (fn, before_p) in rows.items():
        phase = cs.eager_polish if before_p else contextlib.nullcontext
        with phase():
            fn()
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            wrappers["viterbi"].chunks = 0
            fn()
            torch.cuda.synchronize()
            counts = {name: w.launches for name, w in wrappers.items()}
            counts["viterbi_chunks"] = wrappers["viterbi"].chunks
            want = {act: counts[name] for name, act in cs.TRACED_ACTIVITIES}
            traces = {}
            for pad in (0.0, pad_s):
                cs.PROFILE_PAD_S = pad
                traces[pad] = [cs.trace_once(fn) for _ in range(args.traces)]
            cs.PROFILE_PAD_S = pad_s
        usual = collections.Counter(t["activities"] for ts in traces.values() for t in ts).most_common(1)[0][0]
        ref = next(t["by_name"] for ts in traces.values() for t in ts if t["activities"] == usual)
        result["rows"][label] = {"usual_activities": usual}
        for pad, ts in traces.items():
            off = []
            for t in ts:
                got = cs.kernel_counts(t)
                if t["activities"] == usual and got == want:
                    continue
                diff = {name: t["by_name"].get(name, [0])[0] - c for name, (c, _us) in ref.items()}
                diff.update({name: c for name, (c, _us) in t["by_name"].items() if name not in ref})
                off.append({"activities": t["activities"],
                            "kernels_off": {a: c for a, c in got.items() if c != want[a]},
                            "names_off": dict(sorted(((k[:160], v) for k, v in diff.items() if v),
                                                     key=lambda kv: -abs(kv[1]))[:6])})
            result["rows"][label][f"pad {pad}"] = off
            print(f"{label}, pad {pad} s: {len(ts)} traces; "
                  f"{sum(1 for o in off if o['kernels_off'])} with a kernel not as often as launched; "
                  f"{sum(1 for o in off if o['activities'] != usual)} with other than {usual} device activities "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
            for o in off:
                print(f"  {json.dumps(o)}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
