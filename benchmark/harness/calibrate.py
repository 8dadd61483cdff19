"""Readings for the check's limits: the program's numbers and the control's
on many seeds, in one process (the benchmark's runs never run this).

    python3 -m benchmark.harness.calibrate --workload <cell> --seeds 1 2 3 [--control]

For each seed it builds the cell's pool, draws the blocks the check would
compare (`check_blocks` of them, from the seed), and prints one JSON line:
the program's numbers (`voxtpu_torch`'s corpus entry on the card against the
plain float64 reference) and, with --control, the control's: the plain
reference in float32 with every stage's result rounded to TF32 and TF32
matrix products (`reference.analysis.tf32`), put in the program's place and
judged by the same comparison; its path search keeps its running scores
in TF32.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def drawn_blocks(n_pool: int, k: int, seed: int) -> list[int]:
    from benchmark.harness import traffic

    return list(itertools.islice(traffic.visits(n_pool, seed, stream=4), k))


def control_outputs(blk, cfg: dict, device) -> list[dict]:
    """The control in the program's place: per recording, its features."""
    import torch

    from benchmark.reference.analysis import analyze_block, tf32

    return analyze_block(blk.samples, blk.lengths, blk.padded_frames, cfg, torch.float32, device, rnd=tf32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the program and the control for the check's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import check, traffic
    from benchmark.run import Program

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    c = cells.load(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = traffic.make_pool(c.mix, c.config, seed, pinned=True)
        prog = Program(pool, cells.port_config(c.config), dev)
        blocks = drawn_blocks(len(pool), c.mix["check_blocks"], seed)
        outs = [(i, prog.run(i)["recordings"]) for i in blocks]
        del prog
        torch.cuda.empty_cache()
        line = {"workload": c.name, "seed": seed, "blocks": blocks,
                "program": check.numbers(outs, pool, c.config, c.mix, seed, dev)}
        line["program_ok"] = check.verdict(line["program"], c.limits)[0]
        if args.control:
            ctl = [(i, control_outputs(pool[i], c.config, dev)) for i in blocks]
            line["control"] = check.numbers(ctl, pool, c.config, c.mix, seed, dev)
            line["control_ok"] = check.verdict(line["control"], c.limits)[0]
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
