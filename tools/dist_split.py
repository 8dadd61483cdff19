#!/usr/bin/env python3
"""Sharded analysis over the cards of one host: distinct cards against one
card listed as often, and against the unsharded path.

Run from the root of a checkout on a machine with n >= 2 CUDA cards (n =
`torch.cuda.device_count()`; it builds the kernels as chip_smoke.py does):

    python3 tools/dist_split.py [--runs 9]

All float32, over chip_smoke.py's inputs (126 tiles of the bundled
recording; its 16 corpus recordings):

1. `pipeline.analyze` on cuda:0 at CLI_DEFAULT_44K (35,689 frames), and
   `dist.sharded_analyze` exact on a 1 x n mesh of the n distinct cards and
   on cuda:0 listed n times: host-clock ms of each (the median of --runs
   warm runs, each ending in a sync of every card) and of its enqueue
   (until the call returns), the outputs of the two
   meshes compared bit for bit, and one run of the distinct mesh under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync);
2. `cli.corpus_sharded` at BENCH_44K over the 16 recordings on an n x 1
   mesh, distinct and listed, timed the same way and compared bit for bit;
3. `serve.dispatch_split` of 2n recordings of the CLI defaults on the 1024
   rung over the n distinct cards, over cuda:0 listed n times, and as one
   dispatch: device ms (CUDA events, summed over the cards), host ms to
   the last copy back, and the answers compared bit for bit;
4. `dist.launch_multiprocess_dryrun` with n ranks, one card each, over
   NCCL (the backend `init_distributed` picks for a card).

The card's name and power limit lead the output; the last line is one
JSON object.
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


def sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, runs: int) -> tuple[float, float]:
    """Medians of `runs` warm runs, each from a sync of every card: host ms
    until `fn` returns (the enqueue), and until every card is done."""
    fn()
    sync_all()
    enqueue, total = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync_all()
        enqueue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(enqueue), statistics.median(total)


def apart(got: dict, want: dict) -> dict:
    """{key: values that differ in bits} (NaN equals NaN), both on the host."""
    import numpy as np

    out = {}
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        same = (g == w) | (np.isnan(g) & np.isnan(w)) if w.dtype.kind == "f" else g == w
        out[k] = int((~same).sum())
    return out


def host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from voxtpu_torch import cli, dist, serve
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import kernels
    from voxtpu_torch.pipeline import BENCH_44K, CLI_DEFAULT_44K, analyze

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("tools/dist_split.py needs two or more CUDA cards")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    dev = cards[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {n} cards")
    kernels.library()
    result = {"cards": n, "card": card.splitlines()}

    cfg = CLI_DEFAULT_44K
    one = np.asarray(read_wav(str(cs.FIXTURE)).samples, dtype=np.float64)
    sig32 = torch.as_tensor(np.tile(one, cs.TILES), dtype=torch.float32, device=dev)
    frames = frame_signal(sig32, cfg.frame_len, cfg.hop)[None]
    meshes = {"distinct": dist.make_mesh(1, n, cards), "listed": dist.make_mesh(1, n, [dev] * n)}

    # 1. One recording's frames over the frames axis.
    outs = {k: host(dist.sharded_analyze(frames, cfg, m)) for k, m in meshes.items()}
    sync_all()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist.sharded_analyze(frames, cfg, meshes["distinct"])
        synced = ""
    except RuntimeError as e:
        synced = str(e)[-800:]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    part1 = {}
    for name, fn in (("analyze", lambda: analyze(sig32, cfg)),
                     ("distinct", lambda: dist.sharded_analyze(frames, cfg, meshes["distinct"])),
                     ("listed", lambda: dist.sharded_analyze(frames, cfg, meshes["listed"]))):
        part1[f"{name}_enqueue_ms"], part1[f"{name}_ms"] = host_ms(fn, args.runs)
    part1.update(distinct_vs_listed_apart=apart(outs["distinct"], outs["listed"]), host_sync=synced or None)
    result["cli_1xn"] = part1
    print(f"1 x {n}, CLI path ({frames.shape[1]} frames), ms to the end (to return): analyze "
          f"{part1['analyze_ms']:.2f} ({part1['analyze_enqueue_ms']:.2f}); sharded on {n} distinct cards "
          f"{part1['distinct_ms']:.2f} ({part1['distinct_enqueue_ms']:.2f}), on cuda:0 x {n} {part1['listed_ms']:.2f} "
          f"({part1['listed_enqueue_ms']:.2f}); values apart {part1['distinct_vs_listed_apart']}; host sync: "
          f"{synced or 'none'} [{card.splitlines()[0]}]")

    # 2. The corpus block loop over the files axis.
    bcfg = BENCH_44K
    recs, _lengths, _block = cs.corpus_block(one, bcfg.sample_rate)
    rec32 = [torch.as_tensor(r, dtype=torch.float32, device=dev) for r in recs]

    def corpus(mesh):
        files = {}
        cli.corpus_sharded(mesh, list(range(len(recs))), bcfg,
                           lambda b: frame_signal(rec32[b], bcfg.frame_len, bcfg.hop),
                           save=files.__setitem__, read_error=lambda b, e: None)
        return files

    cmeshes = {"distinct": dist.make_mesh(n, 1, cards), "listed": dist.make_mesh(n, 1, [dev] * n)}
    couts = {k: corpus(m) for k, m in cmeshes.items()}
    capart = {}
    for b in range(len(recs)):
        for k, v in apart(couts["distinct"][b], couts["listed"][b]).items():
            capart[k] = capart.get(k, 0) + v
    part2 = {f"{k}_ms": host_ms(lambda m=m: corpus(m), max(3, args.runs // 3))[1] for k, m in cmeshes.items()}
    part2["distinct_vs_listed_apart"] = capart
    result["corpus_nx1"] = part2
    print(f"{n} x 1, corpus_sharded over {len(recs)} recordings at BENCH_44K, the copies to the host included: "
          f"distinct {part2['distinct_ms']:.2f} ms, cuda:0 x {n} {part2['listed_ms']:.2f} ms; values apart "
          f"{capart} [{card.splitlines()[0]}]")

    # 3. The serve split.
    scfg = cli.build_analysis_config(cfg.sample_rate)
    S = serve._samples_for_frames(scfg, 1024)
    B = 2 * n
    stack = torch.zeros((B, S), dtype=torch.float32).pin_memory()
    lengths = torch.zeros((B,), dtype=torch.int64).pin_memory()
    for i in range(B):
        r = recs[i % len(recs)][: S - (i % 4) * int(cfg.sample_rate)]
        stack[i, : len(r)] = torch.as_tensor(r, dtype=torch.float32)
        lengths[i] = len(r)
    splits = {"one": [dev], "distinct": cards, "listed": [dev] * n}
    sres = {}
    for name, devices in splits.items():
        for _ in range(2):  # the second run is timed
            t0 = time.perf_counter()
            out, manifest, timers = serve.dispatch_split(stack, lengths, scfg, devices, 1024)
            dev_s = sum(t.seconds() for t in timers)
            wall = time.perf_counter() - t0
        sres[name] = (serve._unpack_frames(out.numpy(), manifest), dev_s, wall)
    part3 = {f"{k}_device_ms": 1e3 * v[1] for k, v in sres.items()}
    part3.update({f"{k}_host_ms": 1e3 * v[2] for k, v in sres.items()})
    part3["apart"] = {k: apart(sres[k][0], sres["one"][0]) for k in ("distinct", "listed")}
    result["serve_split"] = part3
    print(f"serve dispatch_split of {B} recordings at (B, Fp) = ({B}, 1024): device ms summed over the cards, "
          f"one {part3['one_device_ms']:.2f}, {n} distinct {part3['distinct_device_ms']:.2f}, cuda:0 x {n} "
          f"{part3['listed_device_ms']:.2f}; host ms to the last copy back {part3['one_host_ms']:.2f}, "
          f"{part3['distinct_host_ms']:.2f}, {part3['listed_host_ms']:.2f}; apart from one dispatch "
          f"{part3['apart']} [{card.splitlines()[0]}]")

    # 4. NCCL: n ranks, one card each.
    t0 = time.perf_counter()
    dist.launch_multiprocess_dryrun(n_devices=n, n_processes=n, timeout=600, device=[str(c) for c in cards])
    result["nccl_dryrun_s"] = time.perf_counter() - t0
    print(f"multiprocess dryrun, {n} ranks over NCCL, one card each: {result['nccl_dryrun_s']:.1f} s, process "
          f"starts included")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
