#!/usr/bin/env python3
"""Drive voxtpu_torch's paths on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It fails (nonzero exit, no result lines) without a CUDA device or outside a
checkout. Phases, each an uncaught exception when it fails:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the nine kernels from voxtpu_torch/csrc with nvcc, with the
   compiler's register report; every instantiation of kernels A-F, P and
   X3 (E's thread-block cluster ones, E's prime-factor kernel for the
   lengths that are not powers of two and B's cluster and device layouts
   among them)
   must show 0 bytes of stack frame and spill (STACK_CHECKED); F's shared
   memory a block at C = 33 and 128 in both dtypes; beside it, the build
   of tools/burg_rates.cu's rate probes (phase 10). Then a second process
   starts on the card (`side_checks`, `chip_smoke.py --side`), which runs
   phase 3d and (3e) `analyze` at the CLI defaults with MANY_ESTIMATES
   starting estimates in float64 against the plain CPU path over the
   first 2 s (kernel D once, status 0) beside phases 3-8; main joins it
   after phase 8 and fails if it did;
3. kernels G (pitch_pre), A-D (refine, burg, find_roots, formant_scan) and
   P (polish) against their plain PyTorch versions on the card, at the
   shapes of the CLI path (CLI_DEFAULT_44K over 126 tiles of the bundled
   two-vowels recording: 35,689 frames of 2205 samples), in float64 and
   float32; A, B and C also bit for bit on their first 64 rows alone and on
   all rows in reverse order against the full call, and A's stats (evaluations,
   tap-sides, most Brent iterations) within 0.5% of the plain version's
   evaluations, as on every path below; G bit-exact, a row with a NaN lag
   included; P bit-exact on kernel C's roots and on `polish_edge_cases`
   (zero, NaN and infinite root slots, polynomials whose Newton step is
   not finite, -0.0 coefficients), as on every path below; D bit-exact against the plain
   scan on CPU copies of 4,096 frames, and over every frame of the path by
   `formant_scan_check` (one batched plain step from each output to the
   next), as on every path below; C on `roots_edge_cases` against its plain
   version in both dtypes; then (3b) D on `scan_stress_cases`, its
   adversarial inputs built from the CLI path's float32 resonances, and on
   `scan_shape_cases` (R from 1 to 100, L from 1 to 16), and on the CLI
   path's resonances at L = 17, 64 and 128 estimates (SCAN_LS, seeds from
   `extended_estimates`) in both dtypes; then (3c) B on
   long frames against its plain version, on noisy frames of the recording
   (BURG_LARGE): in each dtype the register layout at up to its 512
   threads a block, its largest frame included, then the rows in shared
   memory above that, up to the largest frame the kernel before it took,
   then the rows over a thread-block cluster of 2, 4 and 8 blocks (32,768,
   65,536 and 131,072 float32, 16,384, 32,768 and 65,536 float64) up to
   its largest frame, then the rows in device memory at the next length;
   each case must take the layout it names; (3d, in the
   side process) B, C and P at N = 33, 64 and 128 (LPC orders to 127,
   ORDER_NS) against their plain versions in both dtypes (`check_orders`);
4. the CLI path: `analyze` in float32 on the card, with every kernel's
   launch count reset just before and read just after; G, A-D and P must
   have run once each and E and F not at all, outputs must be finite
   (hnr_db is -inf exactly where f0 == 0) and every frame's status 0;
5. parity: float64 on the card through the kernels against the plain CPU
   path over the first 2 s, and float32 against float64 on the card over
   the whole signal within the fast-mode budgets, where a frame over a
   budget must be over it in the plain path too (see `check_budgets`);
   float64 launches no P (it never polishes); `analyze` at LPC order 40
   in float64 on the card against the plain CPU path over the first 1 s
   (one second keeps the run's time down: the CPU path runs it three
   times), and an order-127 formant stage into kernel D at R = 127 over
   the same second, bit for bit against the plain scan
   (`check_high_order_path`);
6. the bench path: `analyze` at BENCH_44K (bench.py's 4096/1024, Viterbi
   off as bench.py runs it) over the same 126 tiles (15,369 frames), every
   kernel but F launched once; and bench_viterbi, the same with the
   Viterbi path search, all eight once. On bench_viterbi: all eight kernels
   against their plain versions at its shapes in float64 and float32;
   float32 against float64 within the budgets by phase 5's rule, the plain
   path over the whole signal built from one period of it
   (`plain_periodic`); and `analyze_long` against `analyze` in float64.
   Float64 card-vs-CPU parity over the first 2 s on both; then (6b)
   kernel F on `viterbi_edge_cases` against its plain version, bit for
   bit, in both dtypes;
7. the corpus block: `analyze_batch_padded` over 16 recordings (8 tiles
   each, random gain and trimmed tail), every kernel but F launched once
   for the block in float32 (corpus), all eight with the path search
   (corpus_viterbi); in float64 with the path search each row equal to
   `analyze` of its recording, and all eight kernels against their plain
   versions at the block's shapes (kernel D with one recording's frame
   count as file_len);
8. the flagship path: `analyze` at FLAGSHIP_44K (2048/512, Viterbi off)
   over the 126 tiles, every kernel but F launched once, and
   flagship_viterbi, all eight once; healthy outputs; on flagship_viterbi
   all eight kernels against their plain versions at its shapes and
   float64 card-vs-CPU parity over the first 2 s; then kernel E against
   its plain version at every frame length its gate admits, which must
   be the 161 multiples of 128 up to 20,608 in both dtypes, 20,736
   refused (over a thread-block cluster above 8,192 float32 and 4,096
   float64 samples; the 153 lengths that are not powers of two by the
   prime-factor kernel, in float64 above 14,336 samples with its buffer in
   device memory), each launched once, and in float32 at those 153 lengths
   also against the float64 FFT per frame;
9. the command line, float32, from IEEE-float WAVs of the 126 tiles and of
   the 16 corpus recordings: `python3 -m voxtpu_torch analyze` as a
   subprocess against in-process `analyze`, and `cli.main(["corpus", ...,
   "--batch-files", "16"])` in process (counted launches; its manifest, and
   each file's features against its row of `analyze_batch_padded` over the
   block the command builds), with the command's wall time, reads included;
10. times, float32: each path (cli, bench, bench_viterbi, corpus,
   corpus_viterbi, flagship, flagship_viterbi) end to end and under
   torch.profiler, with kernel P and before it (`eager_polish`): device
   activities, busy ms and idle share side by side, the CLI path's every
   activity name; each trace must hold each kernel as often as the path's
   counted run launched it (P not at all before it; a trace that does not
   is taken again, at most PROFILE_TRACES in all), and the CLI path's at
   most 1,000 device activities. Then each kernel against its plain
   version, with its bound and, for E, the cuFFT library time; A at the
   CLI, bench and flagship shapes and in float64 at the CLI shapes, each
   with its stats and its bound from them; B at the same four, each with
   its plain version, its bound by operations and its bound with the
   float -> double conversions at the rate that tools/burg_rates.cu's probe
   measures in this run (`burg_bound`); C at the same four, each with its
   plain version, its bound by operations and its floor by instruction
   issue from one Laguerre iteration's SASS (`roots_issue_floor`); G also
   at the CLI path's shapes; D at every path's shapes with its chunks, the share whose
   speculation held and the frames re-run in repair; E at the
   bench, corpus-block and flagship shapes beside its bound and cuFFT, and
   in float64 at the bench shapes beside its plain version; F's pre-pass
   and chain apart in each _viterbi path's trace, and at the bench_viterbi
   shapes in both dtypes its time, its time with every frame step's
   records in one chunk, its chain's clocks a step and floor (the chain's probe, through
   `viterbi._launch`), beside its bound and the time to write and read
   back its records (`records_ms`); P beside its bound at 1 + iters passes and at
   the plain version's 1 + 2 iters;
11. serve (`check_serve`): `voxtpu_torch.serve.VoxServer` on the card at the
   CLI defaults (window 3 ms, max_batch 8, bucket 1024), `warmup()` timed;
   64 recordings of 1-8 tiles (gains from `default_rng(0)`) posted as float
   WAVs by 8 client threads at once, half JSON, half npz: each response's
   frames and status equal float32 `analyze` of its recording on the card,
   its features within BUDGETS, the values not bit-equal counted, a batch
   of 2 or more in /stats; one dispatch under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync); a warm
   request's latency (median of 9) and its JSON encoding's share; one
   viterbi=1 request bit for bit with `pitch_path` on the card over the
   returned candidates (kernel F launched); one 16 kHz request at 2048/512
   within BUDGETS of `analyze` (kernel E launched); two /stream sessions
   over the 126 tiles in 1 MiB f32le appends and 512-frame chunks, the
   first bit for bit with `analyze_long(chunk_frames=512)`, the second's
   viterbi=1 close bit for bit with its path search; `python3 -m
   voxtpu_torch serve` as a new process answering one request as the
   in-process server does and exiting 0 on SIGINT. Each run's launches are
   counted; every kernel must have run in the phase;
12. sharded (`check_sharded`), float32, every mesh listing the one card
   several times (PyTorch has no virtual devices; distinct cards would
   overlap, this card runs the blocks in turn): `dist.sharded_analyze` at
   the CLI defaults over the 35,689 frames on a 1x4 mesh (the last shard
   padded), exact: formants bit for bit with `analyze`, the other keys
   within `hold_sharded`'s tolerances, the values not bit-equal counted,
   one run under `set_sync_debug_mode("error")`, G, A, B, C and P once a
   block and D once; the same with --viterbi, F once over the gathered
   candidates, bit for bit with `pitch_path` over them; the halo mode
   (overlap 8) bit for bit with its composition on the card (the
   recording's resonances, each shard's [zeros or left tail | own]
   through D); `cli.corpus_sharded` at BENCH_44K over the 16 corpus
   recordings on a 2x2 mesh, each file against its `analyze_batch_padded`
   row; `serve.dispatch_split` over the card twice against one dispatch,
   and a data_parallel 2 server's dispatch with no host sync, bit for bit;
   `dist.dryrun_multichip(4)` on the card listed 4 times; and
   `dist.launch_multiprocess_dryrun` with two ranks sharing the card over
   gloo (NCCL takes one rank a card). It times the 1x4 exact run and
   `analyze` of the same recording, each beside its launches. Every kernel
   must have run in the phase;
13. bench (`check_bench`): `voxtpu_torch.bench.run()` in process at full
   size (BENCH_44K over the 126 tiles, bench.py's 9 + 8 x 9 timed runs):
   bench.py's keys, finite and positive; one checksummed run launches E,
   G, A-D and P once and F and X3 never, and the whole call each of them
   once a run; the host syncs of one run before its fetch (under
   `set_sync_debug_mode("warn")`); then `python -m voxtpu_torch bench` as a
   new process: exit 0 and one JSON line of bench.py's keys, printed
   beside phase 10's bench row;
14. the autocorrelation backends at the bench shapes (15,369 windowed
   frames of 4096, float32; `check_autocorr_backends`):
   `power_and_autocorrelate(backend="ct_fused_x3")` counted (X3 once,
   nothing else); X3 against its plain version and X3, the "ct" chain and
   E against the float64 FFT on the card, per frame (X3_TOL; E at
   CT_FUSED_F32_TOL); X3 against its plain version at every n its gate
   admits (4 frames each), and with 2 x SMs + 1 frames (each block walks
   two or three) at X3_MANY_NS; float64 into X3 raises ValueError,
   directly and through the backend name; the times (CUDA events, mean of
   5) of X3, E, the "ct" chain and cuFFT rfft-power-irfft, X3's bound
   (`x3_bound`), registers, and 0 bytes of stack frame and spill in X3's
   kernel; then X3 and E (a cluster of 2 blocks a frame) at n = 16,384
   (the bench recording framed 16,384 / 4,096, windowed) against their
   plain versions and the float64 FFT, timed beside cuFFT; then E at
   E_PFA_NS (2,176, 12,288 and 20,096 samples, not powers of two) on the
   recording framed n / (n / 4), windowed, in float32 and float64, against
   its plain version (float32 also against the float64 FFT), timed beside
   its plain version, cuFFT and (float32) X3, with its bound (the
   function's work) and, beside it, the least time for its tensor-core
   products, and the prime-factor kernel's registers and 0 bytes of stack
   and spill; then E in float64 with its buffer in device memory on 2 x SMs +
   1 noise frames (each block walks two or three) at E_DEVICE_MANY_NS;
15. the examples (`check_examples`): examples/torch/pitch_detection.py,
   formant_extraction.py and serving_client.py with `--device cuda`, each
   run counted, checked as tests/test_torch_examples.py checks them;
16. frames of 16,384 and 32,768 (`check_large_frames`): `analyze` at
   LARGE_44K (tests/test_large_frames.py:34-52's configuration, hop n/4)
   over the 126 tiles in float32, counted (E once at 16,384 and never at
   32,768, past its gate; G, A-D and P once; F never), healthy, timed end
   to end; float32 against float64 on the card within the budgets by
   phase 5's rule; float64 on the card against the plain CPU path over
   the first 2 s; E in float64 at 8,192 and 16,384 on the recording's
   frames (clusters of 2 and 4 blocks) and B at the 32,768 path's frames
   in both dtypes and at the 16,384 path's in float64 (the rows over a
   thread-block cluster), and at the first length past the cluster's
   reach in both dtypes (the rows in device memory), against their plain
   versions, timed beside their bounds (E beside cuFFT too; B with its
   cluster size, registers and spill).

Each phase prints the seconds it took.

`python3 chip_smoke.py --kernel-e [DIR]` runs kernel E alone: phase 8's
walk of its gate and phase 14's prime-factor rows, with the voxtpu_torch of
the checkout at DIR (default this one; see `kernel_e_alone`).

The line before the last is one JSON object with each kernel's launches,
error, times and bound; the last is the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "sample-two_vowels.wav"
TILES = 126  # ~357 s of real speech
EXPECTED_FRAMES = 35689  # CLI path, 2205/441
BENCH_FRAMES = 15369  # bench path, 4096/1024
CORPUS_FILES = 16  # `corpus --batch-files` default (voxtpu/cli.py:892)
CORPUS_TILES = 8
SERVE_REQUESTS = 64  # phase 11's /analyze burst, from SERVE_CLIENTS threads at once
SERVE_CLIENTS = 8
KNIFE = 1e-3  # |lag - round(lag)| under which the integer-snap branch decides Brent's path

# Fast-mode budgets, float32 against float64 (tests/test_fast_mode.py:72-79).
BUDGETS = {"f0": 0.7, "f0_strength": 1e-2, "formant_freqs": 2.5, "mfcc": 1e-4}

# Kernel E in float32 against its plain version, per frame, relative to the
# frame's largest value: each of the two transforms rounds to about
# eps_f32 log2(nfft) = 1.6e-6 of the frame's scale at nfft = 8192, 1.7e-6 at
# the gate's largest, 16384.
CT_FUSED_F32_TOL = 4e-6

# Kernel X3 (three bfloat16 passes) per frame, relative to the frame's
# largest value, against its plain version and against the float64 FFT:
# tests/test_autocorr.py:172-190's 2e-5 for voxtpu's x3 (measured up to
# 7.7e-6 on the card); the "ct" chain against the float64 FFT the same.
X3_TOL = 2e-5
# Lengths at which phase 14 also runs X3 with 2 x SMs + 1 frames, so that
# each block walks two or three frames: the ring of x chunks runs ahead
# across frames, and the cc pieces, the power's handover and the lags'
# carry cycle through their stages. Each has a partial chunk and a partial
# lag piece; all but 384 have several tiles, the last one partial (4224:
# 6 chunks a frame, which the ring's 4 stages do not divide).
X3_MANY_NS = (384, 4224, 12928, 20608)
# Frame lengths that are not powers of two at which phase 14 times kernel E
# (its prime-factor kernel) on the recording, framed n / (n / 4): 2^7 x 17,
# 2^12 x 3 (the largest power-of-two factor) and 2^7 x 157 (the largest
# prime factor of voxtpu's lengths).
E_PFA_NS = (2176, 12288, 20096)
# Lengths at which phase 14 runs kernel E's float64 layout with the buffer
# in device memory (n + m complex values past a block's shared memory, n >
# 14,336) on 2 x SMs + 1 frames: the smallest such length, 128 x 113, and
# 128 x 157.
E_DEVICE_MANY_NS = (14464, 20096)
# Frames of seeded noise a length of kernel E's gate walk (phase 8): the
# powers of two as before, and the 153 other lengths.
E_GATE_FRAMES = {"pow2": 256, "other": 32}
# Kernel D's estimate counts past its old cap of 16, up to voxtpu's LANES
# (phase 3b), and the count of the `analyze` that the side process runs.
SCAN_LS = (17, 64, 128)
MANY_ESTIMATES = 24

# Peak rates of one H100 SXM at 700 W: HBM3 bytes/s, float32 and float64
# FLOP/s outside the tensor cores, and dense bfloat16 FLOP/s on them
# (NVIDIA's H100 data sheet).
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12
BF16_TC_OPS_S = 989e12
# Dense TF32 and FP64 FLOP/s on the tensor cores (the same data sheet).
TF32_TC_OPS_S = 495e12
F64_TC_OPS_S = 67e12
# The SM clock those peaks assume (67e12 = 132 SMs x 256 float32 operations
# a clock x 1.98 GHz). Kernel B's bound with its float -> double conversions
# takes the conversions a clock an SM that tools/burg_rates.cu's probe
# measures in the run at this clock.
PEAK_SM_HZ = 1.98e9
RATES_SRC = ROOT / "tools" / "burg_rates.cu"
RATE_PROBES = {"cvt_f64_f32": 0, "dfma_f64": 1, "lds_32bit": 2, "cvt_with_dfma": 3}
# Kernel B on long frames, checked against its plain version on noisy frames
# of the recording: (dtype name, frame length, frames, where the rows live).
# In each dtype the register layout at 480 threads and at its largest frame
# (512 threads x its width c, plus 1), then the rows in shared memory above
# it and at the largest frame the one-block-of-256 kernel that this one
# replaced took (2 n values and its static shared memory within the 232,448
# bytes a block may take), then the rows over a thread-block cluster above
# that (float32: 32,768 over 2 blocks, 65,536 over 4, 131,072 over 8;
# float64: 16,384 over 2, 32,768 over 4, 65,536 over 8) up to its largest
# frame (8 blocks), then the rows in device memory at the next length.
BURG_LARGE = (
    ("float32", 16384, 256, "registers"), ("float32", 17921, 64, "registers"), ("float32", 20480, 256, "shared"),
    ("float32", 28927, 16, "shared"), ("float32", 32768, 256, "cluster"), ("float32", 65536, 64, "cluster"),
    ("float32", 131072, 32, "cluster"), ("float32", 225793, 16, "cluster"), ("float32", 225794, 16, "device"),
    ("float64", 11025, 256, "registers"), ("float64", 11777, 64, "registers"), ("float64", 12288, 256, "shared"),
    ("float64", 14431, 16, "shared"), ("float64", 16384, 256, "cluster"), ("float64", 32768, 64, "cluster"),
    ("float64", 65536, 32, "cluster"), ("float64", 112897, 16, "cluster"), ("float64", 112898, 16, "device"),
)

# The kernels whose build must show 0 bytes of stack frame and spill (phase
# 2), with their instantiation counts. D: three kernels in two dtypes (the
# seed columns' fill for more than 32 estimates the third); E: one a
# power-of-two frame length (128-16384 in either dtype: one block a frame up
# to 8192 in float32 and 4096 in float64, a cluster above), and for the
# other lengths two a power-of-two factor N1 = 128 .. 4096 (the buffer in
# shared memory, the input staged there or read from device memory), in
# float64 also one with the buffer in device memory; A: one in
# each dtype; B: three in each dtype (its register width, the rows in shared
# memory, the rows in device memory) and the cluster layout's kernel in each; C: two in each dtype (N = 14 and the
# capacity, N <= 128); P: two in each dtype (N = 14 in registers, any N <=
# 128); F: the cost
# pre-pass in each dtype, and the chain in each dtype with and without its
# clock probe; X3: one kernel for every n its gate admits.
STACK_CHECKED = {"formant_scan": 6, "ct_fused": 46, "refine_kernel": 2, "burg_kernel": 6, "burg_cluster_kernel": 2,
                 "roots_kernel": 4, "polish_kernel": 4, "viterbi_costs": 2, "viterbi_chain": 4, "ct_x3_kernel": 1}
# The LPC orders above order 13 that the card takes, as N = order + 1
# coefficient pairs: kernels B, C and P at each (phase 3d), up to voxtpu's
# own limit of order 127 (voxtpu/ops/burg_pallas.py:87-88).
ORDER_NS = (33, 64, 128)

KERNELS = {
    # name: (source, replaced TPU kernel, path whose shapes it is timed at)
    "refine": ("voxtpu_torch/csrc/refine.cu", "voxtpu/ops/refine_pallas.py:286", "cli"),
    "burg": ("voxtpu_torch/csrc/burg.cu", "voxtpu/ops/burg_pallas.py:80", "cli"),
    "find_roots": ("voxtpu_torch/csrc/roots.cu", "voxtpu/ops/roots_pallas.py:208", "cli"),
    "formant_scan": ("voxtpu_torch/csrc/formant_scan.cu", "voxtpu/ops/formant_scan_pallas.py:249", "cli"),
    "ct_fused": ("voxtpu_torch/csrc/ct_fused.cu", "voxtpu/ops/ct_fused_pallas.py:187", "bench"),
    "viterbi": ("voxtpu_torch/csrc/viterbi.cu", "voxtpu/ops/viterbi_pallas.py:175", "bench_viterbi"),
    "pitch_pre": ("voxtpu_torch/csrc/pitch_pre.cu", "voxtpu/ops/pitch_pre_pallas.py:110", "bench"),
    # P has no Pallas kernel: voxtpu's polish is jnp that XLA fuses.
    "polish": ("voxtpu_torch/csrc/polish.cu", "voxtpu/roots.py:370", "cli"),
}
# Kernel X3: opt-in (backend="ct_fused_x3"), on no analysis path; phase 14
# runs it through `autocorr.power_and_autocorrelate` at the bench shapes.
# Its launch count stays 0 on every other counted run.
X3 = ("voxtpu_torch/csrc/ct_x3.cu", "voxtpu/ops/ct_fused_pallas.py:130")
OPT_IN = frozenset(["ct_x3"])
# Each wrapper's device kernel, as torch.profiler names it (D's wrapper
# launches formant_scan_speculate and, after it, formant_scan_repair; F's
# launches viterbi_costs and, after it, viterbi_chain).
KERNEL_ACTIVITY = {
    "refine": "refine_kernel", "burg": "burg_kernel", "find_roots": "roots_kernel",
    "formant_scan": "formant_scan_speculate", "ct_fused": "ct_fused_kernel", "viterbi": "viterbi_chain",
    "pitch_pre": "pitch_pre_kernel", "polish": "polish_kernel",
}
# (count, activity) of every device kernel a trace must hold as often as
# the count says: each wrapper's launches, and for F's two device kernels
# the chunks of frame steps its launches ran (`viterbi_path.chunks`).
TRACED_ACTIVITIES = [("viterbi_chunks" if name == "viterbi" else name, act) for name, act in KERNEL_ACTIVITY.items()]
TRACED_ACTIVITIES.append(("viterbi_chunks", "viterbi_costs"))
# torch.profiler keeps the device activities whose timestamps fall inside
# the active step, but the card's activity clock and the host's disagree by
# a fraction of a millisecond (the profiler warns "GPU op timestamp <
# runtime timestamp"). An activity near the step's edge can so land on the
# wrong side: a trace started right at the run lost the run's first
# activities, kernel E among them, or took in the warm-up run's last ones.
# `trace_once` keeps this much idle host time before and after each run.
PROFILE_PAD_S = 0.02
# A trace of a run with ~9,500 launches (a path before kernel P) now and
# then lacks some of them even so, the run's counted launches all right:
# `profile_path` takes a trace that does not hold each kernel as often as
# the run launched it again, this many times in all (tools/trace_window.py
# counts such traces).
PROFILE_TRACES = 3
RUN_ANNOTATION = "chip_smoke traced run"
# The paths whose kernels phases 3 and 6-8 check (bench, corpus and
# flagship with the Viterbi path search, so that F is checked too).
PATHS = {"cli": "CLI path", "bench": "bench path", "corpus": "corpus block", "flagship": "flagship path"}


class Checks:
    """Comparisons of one run; `raise_failures` raises them all at once."""

    def __init__(self):
        self.failures: list[str] = []

    def close(self, name, got, want, rtol, atol, mask=None) -> float:
        """|got - want| <= atol + rtol |want| elementwise (non-finite values
        must agree exactly); returns the max abs error over finite pairs."""
        import torch

        got, want = got.double(), want.double()
        if mask is not None:
            got, want = got[mask], want[mask]
        both = torch.isfinite(got) & torch.isfinite(want)
        err = torch.where(both, (got - want).abs(), 0.0)
        bad = both & (err > atol + rtol * want.abs())
        nonfinite = (torch.isfinite(got) != torch.isfinite(want)) | (
            ~both & (got != want) & ~(torch.isnan(got) & torch.isnan(want))
        )
        max_err = float(err.max()) if err.numel() else 0.0
        nbad = int(bad.sum()) + int(nonfinite.sum())
        print(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol:g}, atol {atol:g}), {nbad} outside")
        if nbad:
            self.failures.append(f"{name}: {nbad} of {got.numel()} values outside tolerance, max_abs_err {max_err:.3e}")
        return max_err

    def equal(self, name, got, want) -> None:
        nbad = int((got != want).sum())
        print(f"  {name}: {nbad} of {got.numel()} differ")
        if nbad:
            self.failures.append(f"{name}: {nbad} of {got.numel()} values differ")

    def true(self, name, ok: bool, detail: str = "") -> None:
        print(f"  {name}: {'ok' if ok else 'FAILED'} {detail}")
        if not ok:
            self.failures.append(f"{name} {detail}")

    def raise_failures(self) -> None:
        if self.failures:
            raise AssertionError("chip_smoke checks failed:\n  " + "\n  ".join(self.failures))


def sync_ms(fn, runs: int = 5) -> float:
    """Median host-clock ms of `runs` warm runs, each ending in a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, runs: int = 5) -> float:
    """Mean device ms of `runs` warm calls between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def hann_windowed(frames):
    """(..., n) frames times the n-point Hann window, as the path windows
    them before kernel E (or cuFFT)."""
    import torch

    from voxtpu_torch.windows import hann

    return frames * torch.as_tensor(hann(frames.shape[-1]), dtype=frames.dtype, device=frames.device)


def pitch_pre_inputs(frames, cfg):
    """Kernel G's arguments at (F, n) raw frames: the quirked lags of the
    Hann-windowed frames (through E or cuFFT, as the path computes them),
    the lag window, bi and the band. Returns (windowed frames, arguments)."""
    import torch

    from voxtpu_torch.autocorr import autocorrelate
    from voxtpu_torch.windows import hanning_lag

    n = frames.shape[-1]
    windowed = hann_windowed(frames)
    hl = torch.as_tensor(hanning_lag(n), dtype=frames.dtype, device=frames.device)
    return windowed, (autocorrelate(windowed, n), hl, n // 2, cfg.sample_rate, cfg.pitch.fmin, cfg.pitch.fmax)


def refine_inputs(windowed, pre_args, cfg) -> tuple:
    """Kernel A's arguments as the path's Brent refine passes them, from the
    Hann-windowed frames and kernel G's arguments (`pitch_pre_inputs`):
    (lag rows, starts, valid, offset, depth, tap bound)."""
    from voxtpu_torch.pitch import REFINE_SINC_DEPTH, lag_candidates
    from voxtpu_torch.sinc import _max_effective_depth

    p = cfg.pitch
    lc = lag_candidates(windowed, cfg.sample_rate, p.fmin, p.fmax, p.max_candidates, precomputed_ac=pre_args[0])
    T = _max_effective_depth(lc.offset, lc.nx, REFINE_SINC_DEPTH, lc.max_x + 1.0)
    return (lc.self_lag, lc.pos, lc.valid, lc.offset, REFINE_SINC_DEPTH, T)


def roots_inputs(windowed, n_coeffs: int) -> tuple:
    """Kernel C's arguments as the formant stage builds them from (F, n)
    Hann-windowed frames: the Burg coefficients (kernel B) reversed under a
    top coefficient of 1, and zero imaginary parts, (F, n_coeffs + 1) each."""
    import torch

    from voxtpu_torch.ops.burg import burg

    coeffs, _ = burg(windowed.contiguous(), n_coeffs)
    poly_re = torch.cat([coeffs.flip(-1), torch.ones_like(coeffs[:, :1])], dim=-1).contiguous()
    return poly_re, torch.zeros_like(poly_re)


def kernel_inputs(frames, cfg):
    """Each kernel's arguments at the slice's shapes, computed by the port's
    own stages from (F, n) raw frames; kernel P's are the reversed monic
    polynomials and the roots kernel C finds for them."""
    import torch

    from voxtpu_torch.formants import formant_candidates
    from voxtpu_torch.ops.find_roots import find_roots

    f = cfg.formant
    windowed, pre_args = pitch_pre_inputs(frames, cfg)
    refine_args = refine_inputs(windowed, pre_args, cfg)
    burg_args = (windowed.contiguous(), f.n_coeffs)
    roots_args = roots_inputs(*burg_args)
    rre, rim, _, _ = find_roots(*roots_args)
    polish_args = (*roots_args, rre, rim)
    rfreq, rbw, _ = formant_candidates(frames, cfg.sample_rate, f.n_coeffs, polish=f.polish)
    est_f = torch.as_tensor(f.estimates, dtype=frames.dtype, device=frames.device)
    scan_args = (rfreq, rbw, est_f, torch.full_like(est_f, f.estimate_bandwidth))
    return {"refine": refine_args, "burg": burg_args, "find_roots": roots_args, "formant_scan": scan_args,
            "pitch_pre": pre_args, "polish": polish_args}, refine_args[2]


def check_pitch_pre(args, checks: Checks, tag: str) -> float:
    """Kernel G against its plain version, bit for bit (csrc/pitch_pre.cu
    repeats every operation in the same order and precision), on the
    path's lags and on a copy of its first 64 rows where row 3 holds a NaN
    lag, which must give an all-zero row. Returns the max abs error."""
    import torch

    from voxtpu_torch.ops import pitch_pre

    ac, hl, bi, sr, fmin, fmax = args
    nan_ac = ac[:64].clone()
    nan_ac[3, 7] = float("nan")
    err = 0.0
    for case, a in (("", ac), (", NaN row", nan_ac)):
        k = pitch_pre.pitch_pre(a, hl, bi, sr, fmin, fmax)
        p = pitch_pre.pitch_pre_plain(a, hl, bi, sr, fmin, fmax)
        for name, kv, pv in zip(("self_lag", "freq", "cand"), k, p):
            checks.equal(f"pitch_pre {name} [{tag}{case}]", kv, pv)
            err = max(err, float((kv.double() - pv.double()).abs().max()))
    checks.true(f"pitch_pre NaN row all zero [{tag}]", not bool(k[0][3].any() or k[2][3].any()))
    return err


def polish_edge_cases(c_re, c_im, z_re, z_im, rows: int = 64) -> tuple:
    """Kernel P's edge rows on a copy of the first `rows` (at least 5) of
    (F, N) coefficients and roots, N >= 2:
    row 0: slot 0 is 0 + 0i and slot 1 is -0.0 + 0i (not live: returned
           as they are);
    row 1: slot 0 NaN, slot 1 +inf (non-finite residual and step);
    row 2: an all-zero polynomial (p = p' = 0: den 0, the step 0 / 0);
    row 3: only the top coefficient, roots 1e-30 (1 + i) and 1e30 (1 - i)
           in turn (z^k under- or overflows: den 0 or inf, the step
           non-finite);
    row 4: -0.0 coefficients (coef's + 0 makes them +0.0)."""
    c_re, c_im, z_re, z_im = (t[:rows].clone() for t in (c_re, c_im, z_re, z_im))
    z_re[0, 0], z_re[0, 1] = 0.0, -0.0
    z_im[0, :2] = 0.0
    z_re[1, 0] = float("nan")
    z_re[1, 1] = float("inf")
    c_re[2:4] = 0.0
    c_im[2:4] = 0.0
    c_re[3, -1] = 1.0
    z_re[3, 0::2], z_im[3, 0::2] = 1e-30, 1e-30
    z_re[3, 1::2], z_im[3, 1::2] = 1e30, -1e30
    c_re[4, 0::3] = -0.0
    c_im[4] = -0.0
    return c_re, c_im, z_re, z_im


def roots_edge_cases(dt) -> list:
    """Kernel C's edge rows, [(name, c_re, c_im)] as NumPy arrays of dtype dt,
    (rows, N) each (index = power; tests/test_torch_roots.py holds the plain
    version to voxtpu's on the same rows). N = 14, one row each: all zero;
    leading zeros (degree 9); low (the lowest nonzero index, zero roots) 1, 2
    and 3; a linear (m0 = 1) and a quadratic (m0 = 2) live part; -0.0
    coefficients at the bottom (low 1), the top (degree 12) and inside; a
    row whose first Laguerre result is exactly 0 (POLY_DIV_ZERO, the later
    round skipped): the quartic whose Taylor terms at the start -2 - 2i make
    the first step exactly 2 + 2i in dyadic arithmetic, with constant term
    2^-70, so that |p(0)| <= 1e-16 freezes z there; and complex
    coefficients (degree 7). N = 1, 2 and 3: constants, linear and quadratic
    rows; N = 32: degree 16 and, with low 2, degree 18. The polynomials are
    products of roots in the annulus 0.3 <= |z| <= 0.6, in conjugate pairs
    (and 0.5) where the coefficients are real, drawn with seed 16: of seeds
    13-22 the first whose rows all settle in 20 Laguerre steps in both
    dtypes (voxtpu's float32 answer within 1e-4 of the plain version's, not
    hanging on the last bit of a libm call; higher degrees and other seeds
    end unsettled in float32, where two libms part by up to 1)."""
    rng = np.random.default_rng(16)

    def poly(n, real: bool = True):
        """Coefficients (index = power) of n roots in the annulus."""
        r = rng.uniform(0.3, 0.6, n) * np.exp(1j * rng.uniform(0.05, np.pi - 0.05, n))
        if real:
            r = np.concatenate([r[: n // 2], r[: n // 2].conj(), [0.5] * (n % 2)])
        return np.poly(r)[::-1]

    c14 = np.zeros((10, 14), complex)
    c14[1, :10] = poly(9)
    for row, low in ((2, 1), (3, 2), (4, 3)):
        c14[row, low:] = poly(13 - low)
    c14[5, 4:6] = (0.75, -1.5)  # linear live part
    c14[6, 2:5] = (1.0, -2.5, 2.0)  # quadratic live part
    c14[7] = poly(13)
    c14[8, :5] = (2.0**-70, -16.875 + 18.125j, 0.875 + 25.75j, 6.515625 + 6.234375j, 1.0)  # POLY_DIV_ZERO
    c14[9, :8] = poly(7, real=False)
    c32 = np.zeros((2, 32), complex)
    c32[0, :17] = poly(16)
    c32[1, 2:21] = poly(18)
    cases = [
        ("N = 14", c14),
        ("N = 1", np.array([[2.0], [0.0], [-1.5j]])),
        ("N = 2", np.array([[1.0, 2.5], [0.0, 3.0], [2.0, 0.0], [1 - 2j, 0.5j]])),
        ("N = 3", np.array([[1.0, -2.5, 2.0], [1.0, 2.0, 5.0], [0.0, 1.0, 1.0], [2j, 1 - 1j, 0.5]])),
        ("N = 32", c32),
    ]
    out = []
    for name, c in cases:
        re, im = np.ascontiguousarray(c.real, dt), np.ascontiguousarray(c.imag, dt)
        if name == "N = 14":
            re[7, 0], im[7, 0], re[7, 13], im[7, 13] = -0.0, -0.0, -0.0, -0.0
            re[7, 5::4] = -0.0
        out.append((name, re, im))
    return out


def roots_order_cases(dt) -> list:
    """Kernel C's rows at the LPC orders above the register instantiation,
    [(name, c_re, c_im)] as NumPy arrays of dtype dt, (4, N) each for N =
    33, 64 and 128 (orders 32, 63 and 127; tests/test_torch_roots.py holds
    the plain version to voxtpu's on them): a full-degree row at N = 33
    (roots 0.9 (1 +- 5%) spread over the circle, seed 0, conjugate pairs),
    and at each N a degree-12 row under leading zeros, a row of 13 live
    roots above N - 14 zero roots, and a row of 20 live roots from index 5.
    Every row settles in 20 Laguerre steps in float64. Full-degree rows at
    N = 64 and 128 do not: the reference's n, the first round's live degree
    held through deflation, leaves its roots 1e-4 to 1 from the true ones
    after 20 steps, in voxtpu as in the port, and two libms part there."""
    rng = np.random.default_rng(0)

    def circle(n, rho=0.9):
        m = n // 2
        ang = np.pi * (np.arange(m) + 0.5) / m + rng.uniform(-0.3, 0.3, m) * np.pi / m
        r = rho * (1 + rng.uniform(-0.05, 0.05, m)) * np.exp(1j * ang)
        return np.poly(np.concatenate([r, r.conj(), [rho * 0.9] * (n % 2)]))[::-1]

    out = []
    for N in (33, 64, 128):
        c = np.zeros((4, N), complex)
        c[0] = circle(32) if N == 33 else np.concatenate([circle(24, 0.7), np.zeros(N - 25)])
        c[1, :13] = circle(12, 0.6)
        c[2, N - 14:] = circle(13, 0.8)
        c[3, 5:26] = circle(20, 0.75)
        out.append((f"N = {N}", np.ascontiguousarray(c.real, dt), np.ascontiguousarray(c.imag, dt)))
    return out


def bits(x):
    """x's bit patterns: equal bits are equal values, NaN and -0.0 included."""
    import torch

    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def check_polish(args, checks: Checks, tag: str) -> float:
    """Kernel P against its plain version by bit pattern (csrc/polish.cu
    repeats every operation in the same order and precision), on the path's
    polynomials and kernel C's roots, and on `polish_edge_cases` of its
    first 64 rows, whose zero slots and non-finite steps must come back as
    they went in. Returns the max abs error over finite values."""
    import torch

    from voxtpu_torch.ops import polish

    edge = polish_edge_cases(*args)
    err = 0.0
    for case, a in (("", args), (", edge rows", edge)):
        k = polish.polish_roots(*a)
        p = polish.polish_roots_plain(*a)
        for name, kv, pv in zip(("re", "im"), k, p):
            nbad = int((bits(kv) != bits(pv)).sum())
            checks.true(f"polish {name} [{tag}{case}]", nbad == 0, f"({nbad} of {kv.numel()} differ in bits)")
            fin = torch.isfinite(kv) & torch.isfinite(pv)
            err = max(err, float((kv - pv)[fin].abs().max()) if bool(fin.any()) else 0.0)
    kept = ((0, slice(0, 2)), (1, slice(0, 2)), (2, slice(None)), (3, slice(None)))
    same = all(torch.equal(bits(out[r, sl]), bits(z[r, sl])) for out, z in zip(k, edge[2:]) for r, sl in kept)
    checks.true(f"polish edge rows 0-3 returned as they went in [{tag}]", same)
    return err


def check_kernels(frames, cfg, checks: Checks, label: str, file_len: int | None = None) -> tuple[dict, dict]:
    """Kernels G, A-D and P against their plain versions on the same inputs,
    for one dtype, at the shapes of (F, n) frames. file_len: the frames are
    F / file_len recordings of file_len frames each, as the corpus block
    hands them to kernel D. Returns {kernel: max_abs_err} and kernels D's
    and A's runs: {"args": (rf, rb, ef, eb, file_len), "stats": D's repair
    counts, "refine_args": A's arguments, "refine_stats": A's stats}."""
    import torch

    from voxtpu_torch.ops import burg, find_roots, formant_scan, refine

    dt = frames.dtype
    f64 = dt == torch.float64
    tag = f"{label}, {'f64' if f64 else 'f32'}"
    args, valid = kernel_inputs(frames, cfg)
    errs = {"pitch_pre": check_pitch_pre(args["pitch_pre"], checks, tag)}

    sk = torch.empty(3, dtype=torch.int64, device=frames.device)
    sp = torch.empty_like(sk)
    xk, fk = refine.refine(*args["refine"], stats=sk)
    xp, fp = refine.refine_plain(*args["refine"], stats=sp)
    refine_stats = check_refine_runs(args["refine"], xk, fk, sk, sp, checks, tag)
    if f64:
        # tests/test_pallas.py:51-52: Brent's trajectory is chaotic in the
        # last ulp, so agreement is to Brent's tolerance.
        e1 = checks.close(f"refine x [{tag}]", xk, xp, 1e-6, 1e-5, mask=valid)
    else:
        # The f32 fuzz test's bracket (tests/test_pallas.py:224-235): Brent
        # stops at tol_act ~ sqrt(eps_f32)|x|. Where the start or either
        # result sits within KNIFE of an integer, the integer-snap branch
        # decides which side of a flat top Brent ends on (the knife edge of
        # tests/test_traces_16k.py:64-76): there the lag agrees to rtol 5e-3
        # and f(x) to the fuzz tolerance below.
        x0 = args["refine"][1]
        knife = torch.zeros_like(valid)
        for x in (x0, xk, xp):
            knife |= (x - x.round()).abs() < KNIFE
        lag = xp + args["refine"][3]
        ok = ((xk - xp).abs() <= 0.2) | (knife & ((xk - xp).abs() <= 5e-3 * lag.abs()))
        e1 = float((xk - xp)[valid].abs().max())
        nknife = int((valid & knife & ((xk - xp).abs() > 0.2)).sum())
        checks.true(f"refine x [{tag}]", bool(ok[valid].all()),
                    f"max_abs_err {e1:.3e} (atol 0.2; {nknife} knife-edge lanes beyond it, within lag rtol 5e-3)")
    ftol = (1e-5, 1e-7) if f64 else (1e-3, 5e-4)
    e2 = checks.close(f"refine f(x) [{tag}]", fk, fp, *ftol, mask=valid)
    errs["refine"] = max(e1, e2)

    ck, sk = burg.burg(*args["burg"])
    cp, sp = burg.burg_plain(*args["burg"])
    errs["burg"] = checks.close(f"burg coeffs [{tag}]", ck, cp, *burg_tol(dt))
    checks.equal(f"burg status [{tag}]", sk, sp)
    check_burg_runs(args["burg"], ck, sk, checks, tag)

    rk = find_roots.find_roots(*args["find_roots"])
    rp = find_roots.find_roots_plain(*args["find_roots"])
    e1 = checks.close(f"roots re [{tag}]", rk[0], rp[0], *roots_tol(dt))
    e2 = checks.close(f"roots im [{tag}]", rk[1], rp[1], *roots_tol(dt))
    errs["find_roots"] = max(e1, e2)
    checks.equal(f"roots count [{tag}]", rk[2], rp[2])
    checks.equal(f"roots status [{tag}]", rk[3], rp[3])
    check_roots_runs(args["find_roots"], rk, checks, tag)
    errs["polish"] = check_polish(args["polish"], checks, tag)

    # Bit-exact. One recording: over the first 4,096 frames, as the path's
    # call and as 8 recordings of 512 frames (the carry resets at each).
    # With file_len: the whole block, as the path calls it. The plain scan is
    # a Python loop over a recording's frames: it runs on CPU copies, where
    # a step takes a fraction of its time on the card.
    rf, rb, ef, eb = args["formant_scan"]
    if file_len is None:
        h = min(4096, len(rf) // 8 * 8)
        cases = ((f"first {h} frames, one recording", len(rf), None, h),
                 (f"first {h} frames, 8 x {h // 8} frames", h, h // 8, h))
    else:
        cases = ((f"{len(rf) // file_len} recordings x {file_len} frames", len(rf), file_len, len(rf)),)
    err = 0.0
    for case, frames_in, fl, cmp in cases:
        fk_, bk_ = formant_scan.formant_scan(rf[:frames_in], rb[:frames_in], ef, eb, file_len=fl)
        fk_, bk_ = fk_[:cmp].cpu(), bk_[:cmp].cpu()
        fp_, bp_ = formant_scan.formant_scan_plain(*[t.cpu() for t in (rf[:cmp], rb[:cmp], ef, eb)], file_len=fl)
        checks.equal(f"formant_scan freqs [{tag}, {case}]", fk_, fp_)
        checks.equal(f"formant_scan bws [{tag}, {case}]", bk_, bp_)
        err = max(err, float((fk_ - fp_).abs().max()), float((bk_ - bp_).abs().max()))
    errs["formant_scan"] = err
    # Every frame of the path, as the path calls the kernel: one batched
    # plain step from each output to the next (formant_scan_check).
    stats = check_scan_every_frame(rf, rb, ef, eb, file_len, checks, f"{tag}, every frame of {len(rf)}")
    return errs, {"args": (rf, rb, ef, eb, file_len), "stats": stats, "refine_args": args["refine"],
                  "refine_stats": refine_stats, "burg_args": args["burg"], "roots_args": args["find_roots"]}


def roots_tol(dt) -> tuple[float, float]:
    """Kernel C against its plain version: f64 1e-9 on unit-circle roots;
    f32: Laguerre runs all 20 steps at f32 resolution and deflation carries
    each root's error into the next."""
    import torch

    return (1e-9, 1e-9) if dt == torch.float64 else (1e-3, 1e-3)


def check_roots_runs(args, rk, checks: Checks, tag: str) -> None:
    """Kernel C's first 64 rows alone and all rows in reverse order give the
    same bits as in the full call (rk): a polynomial's roots depend on its
    own row alone."""
    import torch

    from voxtpu_torch.ops import find_roots

    c_re, c_im = args
    head = min(64, len(c_re))
    rev = torch.arange(len(c_re) - 1, -1, -1, device=c_re.device)
    for case, idx in ((f"first {head} rows alone", slice(0, head)), ("rows in reverse order", rev)):
        got = find_roots.find_roots(c_re[idx].contiguous(), c_im[idx].contiguous())
        apart = ((bits(got[0]) != bits(rk[0][idx])) | (bits(got[1]) != bits(rk[1][idx]))).any(dim=-1)
        ndiff = int((apart | (got[2] != rk[2][idx]) | (got[3] != rk[3][idx])).sum())
        checks.true(f"roots batch invariance [{tag}, {case}]", ndiff == 0,
                    f"({ndiff} of {len(got[2])} rows differ in bits from the full call)")


def check_roots_edge(dt, dev, checks: Checks, tag: str) -> None:
    """Kernel C on `roots_edge_cases` against its plain version on the card,
    at `roots_tol`, with count and status equal."""
    import torch

    from voxtpu_torch.ops import find_roots

    for name, re_, im_ in roots_edge_cases(np.float32 if dt == torch.float32 else np.float64):
        c = (torch.as_tensor(re_, device=dev), torch.as_tensor(im_, device=dev))
        rk, rp = find_roots.find_roots(*c), find_roots.find_roots_plain(*c)
        for part, k, p in zip(("re", "im"), rk, rp):
            checks.close(f"roots {part} [{tag}, edge rows {name}]", k, p, *roots_tol(dt))
        checks.equal(f"roots count and status [{tag}, edge rows {name}]", torch.stack(rk[2:]), torch.stack(rp[2:]))


def burg_tol(dt) -> tuple[float, float]:
    """Kernel B against its plain version: f64 as tests/test_pallas.py:160;
    f32: both sum in float64, in different orders, so a reflection
    coefficient can round to float32 on either side of a tie (1 ulp), and
    later orders carry that on."""
    import torch

    return (1e-10, 1e-12) if dt == torch.float64 else (1e-4, 1e-5)


def check_burg_runs(args, ck, sk, checks: Checks, tag: str) -> None:
    """Kernel B's first 64 rows alone and all rows in reverse order give the
    same bits as in the full call (ck, sk): a frame's sums run in an order
    fixed by its length alone."""
    import torch

    from voxtpu_torch.ops import burg

    x, p = args
    head = min(64, len(x))
    rev = torch.arange(len(x) - 1, -1, -1, device=x.device)
    for case, idx in ((f"first {head} rows alone", slice(0, head)), ("rows in reverse order", rev)):
        cb, sb = burg.burg(x[idx].contiguous(), p)
        ndiff = int(((bits(cb) != bits(ck[idx])).any(dim=-1) | (sb != sk[idx])).sum())
        checks.true(f"burg batch invariance [{tag}, {case}]", ndiff == 0,
                    f"({ndiff} of {len(cb)} frames differ in bits from the full call)")


def burg_large_frames(n: int, frames: int, dt, dev):
    """`frames` Hann-windowed frames of n samples of the recording, tiled,
    spread over it, plus seeded noise of 0.1 (tests/test_large_frames.py:
    _noisy_frames): real speech, conditioned as it is."""
    import torch

    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.windows import hann

    one = np.asarray(read_wav(str(FIXTURE)).samples, dtype=np.float64)
    sig = np.tile(one, -(-(n * 4) // len(one)) + 1)
    starts = np.linspace(0, len(sig) - n, frames).astype(int)
    x = np.stack([sig[s : s + n] for s in starts]) + 0.1 * np.random.default_rng(7).standard_normal((frames, n))
    return torch.as_tensor(x * hann(n), dtype=dt, device=dev).contiguous()


def check_burg_large(checks: Checks, dev) -> None:
    """Kernel B on long frames against its plain version on noisy frames of
    the recording (BURG_LARGE), order 13, with the launch the wrapper picks;
    each case must take the layout it names."""
    import torch

    from voxtpu_torch.ops import burg

    for dname, n, frames, rows in BURG_LARGE:
        dt = getattr(torch, dname)
        config = burg.launch_config(n, dt)
        x = burg_large_frames(n, frames, dt, dev)
        tag = f"{frames} frames of {n}, {dname}, {config}"
        checks.true(f"burg layout [{tag}]", config.rows == rows, f"(rows in {rows} wanted)")
        ck, sk = burg.burg(x, 13)
        cp, sp = burg.burg_plain(x, 13)
        checks.close(f"burg coeffs [{tag}]", ck, cp, *burg_tol(dt))
        checks.equal(f"burg status [{tag}]", sk, sp)


def refine_stats_text(stats, live: int) -> str:
    evals, taps, most = stats
    return (f"{evals} evaluations ({evals / max(live, 1):.3f} a live candidate), {taps} tap-sides, at most {most} "
            f"Brent iterations")


def check_refine_runs(args, xk, fk, sk, sp, checks: Checks, tag: str) -> tuple:
    """Kernel A's runs beyond its outputs: the first 64 rows alone and all
    rows in reverse order give the same bits as in the full call (a
    candidate's sums depend on its own depth alone), and the kernel's stats
    (sk) against the plain version's (sp) on the same rows: their
    evaluation totals within 0.5% (the float32 trajectories part where the
    sums round apart). Returns the kernel's stats."""
    import torch

    from voxtpu_torch.ops import refine

    y, x0, valid, *rest = args
    head = min(64, len(y))
    rev = torch.arange(len(y) - 1, -1, -1, device=y.device)
    for case, idx in ((f"first {head} rows alone", slice(0, head)), ("rows in reverse order", rev)):
        xb, fb = refine.refine(y[idx].contiguous(), x0[idx].contiguous(), valid[idx].contiguous(), *rest)
        ndiff = int(((bits(xb) != bits(xk[idx])) | (bits(fb) != bits(fk[idx]))).sum())
        checks.true(f"refine batch invariance [{tag}, {case}]", ndiff == 0,
                    f"({ndiff} of {xb.numel()} candidates differ in bits from the full call)")
    live = int(valid.sum())
    ks, ps = tuple(int(v) for v in sk.cpu()), tuple(int(v) for v in sp.cpu())
    print(f"  refine stats [{tag}]: kernel {refine_stats_text(ks, live)}; plain {refine_stats_text(ps, live)}")
    checks.true(f"refine stats, evaluations within 0.5% of plain [{tag}]", abs(ks[0] - ps[0]) <= 0.005 * ps[0],
                f"({ks[0]} vs {ps[0]})")
    return ks


def scan_stats_text(stats) -> str:
    chunks, rerun, frames = stats
    return f"{chunks} chunks, {chunks - rerun} held ({(chunks - rerun) / chunks:.4f}), {frames} frames re-run"


def check_scan_every_frame(rf, rb, ef, eb, file_len, checks: Checks, tag: str) -> list:
    """Kernel D's output on (rf, rb) held to the serial scan over every frame
    by `formant_scan_check`; returns the call's repair counts (chunks,
    chunks re-run, frames re-run)."""
    import torch

    from voxtpu_torch.ops import formant_scan

    counts = torch.empty(3, dtype=torch.int64, device=rf.device)
    fk, bk = formant_scan.formant_scan(rf, rb, ef, eb, file_len=file_len, stats=counts)
    stats = counts.tolist()
    bad = formant_scan.formant_scan_check(rf, rb, ef, eb, fk, bk, file_len=file_len)
    checks.true(f"formant_scan [{tag}]", bad.numel() == 0,
                f"({bad.numel()} frames differ, first {bad[:4].tolist()}); {scan_stats_text(stats)}")
    return stats


def check_scan_stress(rf, rb, ef, eb, checks: Checks) -> None:
    """Kernel D on `scan_stress_cases` and `scan_shape_cases` (the latter as
    one recording and as 5), built from float32 resonances, in float32 and
    float64: every frame by `formant_scan_check`, and bit for bit against
    the plain scan on CPU copies where a recording has at most 4,096 frames
    (the plain scan is a Python loop over them). The cases of more than
    4,096 frames are timed in float32: the zero spans show the repair
    chain's cost where speculation cannot hold."""
    import torch

    from voxtpu_torch.ops import formant_scan

    cases = [(name, crf, crb, fl, ef, eb) for name, crf, crb, fl in scan_stress_cases(rf, rb, formant_scan.CHUNK)]
    for name, crf, crb, sef, seb in scan_shape_cases(rf, rb):
        cases += [(name, crf, crb, len(crf), sef, seb), (f"{name}, 5 recordings", crf, crb, len(crf) // 5, sef, seb)]
    for name, crf, crb, fl, ef, eb in cases:
        for dt in (torch.float32, torch.float64):
            x = [t.to(dt) for t in (crf, crb, ef, eb)]
            tag = f"{name}, {'f64' if dt == torch.float64 else 'f32'}"
            check_scan_every_frame(*x, fl, checks, tag)
            if dt == torch.float32 and len(crf) > 4096:
                ms = event_ms(lambda: formant_scan.formant_scan(*x, file_len=fl), runs=3)
                print(f"  formant_scan [{tag}]: kernel {ms:.3f} ms ({len(crf)} frames)")
            if fl <= 4096:
                fk, bk = [t.cpu() for t in formant_scan.formant_scan(*x, file_len=fl)]
                fp, bp = formant_scan.formant_scan_plain(*[t.cpu() for t in x], file_len=fl)
                checks.true(f"formant_scan vs plain [{tag}]", torch.equal(fk.view(torch.uint8), fp.view(torch.uint8))
                            and torch.equal(bk.view(torch.uint8), bp.view(torch.uint8)), "(bit for bit)")


def stack_frames(log: str, kernel: str) -> dict:
    """{kernel: (stack frame, spill stores, spill loads) in bytes} of every
    kernel whose name holds `kernel` in the build's `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and kernel in name:
            out[name] = tuple(int(g) for g in m.groups())
        name = None
    return out


def kernel_registers(log: str, kernel: str) -> dict:
    """{kernel: registers a thread} of every kernel whose name holds `kernel`
    in the build's `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            out[name] = int(m.group(1))
            name = None
    return out


def sass(lib_path: Path, kernel: str) -> dict:
    """{function: [(address, opcode, instruction)]} of every function whose
    name holds `kernel` in the library's SASS (`cuobjdump -sass`, beside
    nvcc); {} where the toolkit has no cuobjdump."""
    from voxtpu_torch.ops import kernels

    nvcc = kernels.find_nvcc()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and name:
            ins = m.group(2).strip()
            words = ins.split()
            out[name].append((int(m.group(1), 16), words[1] if words[0].startswith("@") else words[0], ins))
    return out


def laguerre_loop(instructions: list) -> dict | None:
    """Kernel C's Laguerre iteration in one function's SASS (`sass`): the
    shortest backward branch whose span holds a MUFU (the divisions'
    reciprocals, the square roots). Returns its static instruction count,
    the float64 ones among them, and the counts of the loops nested in it
    (whose bodies run more than once an iteration); None if no loop holds
    a MUFU."""
    loops = []
    for addr, op, ins in instructions:
        m = re.search(r"0x([0-9a-f]+)", ins) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))

    def body(lo, hi):
        return [(op, ins) for addr, op, ins in instructions if lo <= addr <= hi]

    spans = [span for span in loops if any(op.startswith("MUFU") for op, _ in body(*span))]
    if not spans:
        return None
    lo, hi = min(spans, key=lambda s: s[1] - s[0])
    ops = [op for op, _ in body(lo, hi)]
    return {"instructions": len(ops), "float64": sum(op[0] == "D" and op != "DEPBAR" for op in ops),
            "nested": [len(body(a, b)) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]}


def roots_loops(lib_path: Path, N: int) -> dict:
    """{"f32": loop, "f64": loop}: `laguerre_loop` of the roots_kernel that
    runs (B, N) rows of each dtype (the one templated on N where there is
    one), None without cuobjdump."""
    funcs = sass(lib_path, "roots_kernel")
    out = {}
    for dname, tag in (("f32", "roots_kernelIf"), ("f64", "roots_kernelId")):
        names = sorted((n for n in funcs if tag in n), key=lambda n: f"Li{N}E" not in n)
        out[dname] = laguerre_loop(funcs[names[0]]) if names else None
    return out


def roots_issue_floor(c_re, c_im, per_iter: int, sms: int, float64: int = 0) -> tuple[float, float]:
    """Kernel C's least time by instruction issue, in ms, at (F, N)
    coefficients, from the instructions of one Laguerre iteration (`per_iter`,
    `float64` of them on the float64 pipe, which takes a warp's instruction
    in 2 clocks): each warp of 32 rows runs 20 iterations for each round that
    its longest row needs (min(max(m0 - 2, 0), N - 3), m0 the live degree).
    Returns (every warp on the card's 4 x sms schedulers at an even share,
    the busiest scheduler's ceil(warps / (4 sms)) warps of the most
    iterations), at PEAK_SM_HZ."""
    import torch

    F, N = c_re.shape
    nz = (c_re != 0) | (c_im != 0)
    idx = torch.arange(N, device=c_re.device)
    deg = torch.where(nz, idx, 0).amax(dim=1)
    low = torch.where(nz, idx, N - 1).amin(dim=1)
    rounds = (deg - low - 2).clamp(min=0, max=max(N - 3, 0))
    warps = -(-F // 32)
    pad = torch.zeros(warps * 32 - F, dtype=rounds.dtype, device=rounds.device)
    warp_iters = 20 * torch.cat([rounds, pad]).reshape(warps, 32).amax(dim=1)
    cycles = per_iter + float64
    schedulers = 4 * sms
    even = float(warp_iters.sum()) * cycles / (schedulers * PEAK_SM_HZ)
    busiest = -(-warps // schedulers) * float(warp_iters.max()) * cycles / PEAK_SM_HZ
    return even * 1e3, busiest * 1e3


def scan_stress_cases(rf, rb, chunk: int, span: int = 2000, uniform: int = 20000, block: int = 16,
                      seed: int = 0) -> list:
    """Kernel D's adversarial inputs, built from a path's resonances rf, rb
    (F, R), R >= 8, on their device: [(name, rf, rb, file_len)].

    (a) three spans of `span` all-zero rows inserted between speech: no
        winner, so the carry is held, and a chunk speculated from the seed
        inside a span cannot meet the true carry there;
    (b) `uniform` rows of seeded uniform values in [0, 5000) Hz, every 7th
        row with one of its first six resonances copied into the next (the
        step-3 dedup branch, argmin ties, step 4's contains test), every
        11th with a later one copied, and one row NaN from its fourth
        resonance on (the first NaN distance wins);
    (c) `block` recordings of F // block frames, one of them all zeros;
    (d) F in {1, C - 1, C, C + 1, 3C + 7} for the chunk length C, each as
        one recording and as recordings of the largest proper divisor of F
        that is not a multiple of C (1 where there is none)."""
    import torch

    F, R = rf.shape
    dev, dt = rf.device, rf.dtype
    cuts = [0, F // 4, F // 2, 3 * F // 4, F]
    zero = torch.zeros((span, R), dtype=dt, device=dev)

    def with_spans(x):
        parts = [x[a:b] for a, b in zip(cuts, cuts[1:])]
        return torch.cat([p for part in parts[:-1] for p in (part, zero)] + [parts[-1]])

    cases = [(f"(a) three spans of {span} zero rows", with_spans(rf), with_spans(rb), F + 3 * span)]

    rng = np.random.default_rng(seed)
    uf, ub = rng.uniform(0.0, 5000.0, (2, uniform, R))
    for step, lo, hi in ((7, 0, 6), (11, 6, R - 1)):
        rows = np.arange(0, uniform, step)
        cols = rng.integers(lo, hi, len(rows))
        uf[rows, cols + 1] = uf[rows, cols]
        ub[rows, cols + 1] = ub[rows, cols]
    uf[uniform // 2, 3:] = np.nan
    cases.append((f"(b) {uniform} uniform rows, duplicated pairs, a NaN row",
                  torch.as_tensor(uf, dtype=dt, device=dev), torch.as_tensor(ub, dtype=dt, device=dev), uniform))

    n = F // block
    cf, cb = rf[: block * n].clone(), rb[: block * n].clone()
    cf[5 * n: 6 * n] = 0.0
    cb[5 * n: 6 * n] = 0.0
    cases.append((f"(c) {block} recordings x {n} frames, recording 5 all zeros", cf, cb, n))

    for m in (1, chunk - 1, chunk, chunk + 1, 3 * chunk + 7):
        fl = max([d for d in range(1, m) if m % d == 0 and d % chunk] or [1])
        cases.append((f"(d) F={m}, one recording", rf[:m], rb[:m], m))
        cases.append((f"(d) F={m}, recordings of {fl}", rf[:m], rb[:m], fl))
    return cases


def scan_shape_cases(rf, rb, frames: int = 300) -> list:
    """Kernel D at shapes other than the paths': [(name, rf, rb, ef, eb)]
    from the first `frames` rows of a path's resonances: rows cut to R = 1,
    3 or 5, or widened to R = 40 or 100 with the rows of the next frames;
    seeds of L = 1 to 16 estimates spread over 300-5000 Hz."""
    import torch

    def widen(a, R):
        a = a[:frames]
        return torch.cat([a.roll(-k, 0) for k in range(-(-R // a.shape[1]))], dim=1)[:, :R].contiguous()

    cases = []
    for R, L in ((1, 4), (3, 3), (5, 1), (32, 6), (32, 16), (40, 8), (100, 16), (100, 2)):
        est = torch.as_tensor(np.linspace(300.0, 5000.0, L), dtype=rf.dtype, device=rf.device)
        cases.append((f"R={R}, L={L}", widen(rf, R), widen(rb, R), est, torch.ones_like(est)))
    return cases


def extended_estimates(L: int) -> tuple:
    """L >= 4 starting estimates: MALE_FORMANT_ESTIMATES (lib.rs:27), then
    every 250 Hz from 3,500 Hz. Kernel D tracks the first six and keeps the
    rest at their seeds, as voxtpu does for up to LANES = 128."""
    from voxtpu_torch.formants import MALE_FORMANT_ESTIMATES

    return tuple(MALE_FORMANT_ESTIMATES) + tuple(3500.0 + 250.0 * i for i in range(L - 4))


def check_scan_estimates(rf, rb, checks: Checks) -> None:
    """Kernel D past its old cap of 16 estimates: L in SCAN_LS on a path's
    resonances (rf, rb) in float32 and float64, seeds from
    `extended_estimates`, every frame held to the serial scan by
    `formant_scan_check` (bit for bit)."""
    import torch

    for dt in (torch.float32, torch.float64):
        for L in SCAN_LS:
            ef = torch.as_tensor(extended_estimates(L), dtype=dt, device=rf.device)
            check_scan_every_frame(rf.to(dt), rb.to(dt), ef, torch.ones_like(ef), len(rf), checks,
                                   f"L = {L}, {'f64' if dt == torch.float64 else 'f32'}")


def bench_kernel_inputs(frames, out, cfg):
    """Kernel E's, F's and G's arguments at a path's shapes: the
    Hann-windowed frames as (F, n), the DP inputs that `pitch_path` builds
    from the path's own candidates and frame intensities, (F, C) for one
    recording or (B, F, C) for a block of B, and `pitch_pre_inputs`."""
    from voxtpu_torch.pipeline import _intensity, _local_peak
    from voxtpu_torch.viterbi import PathConfig, path_inputs

    n = frames.shape[-1]
    windowed, pre_args = pitch_pre_inputs(frames.reshape(-1, n), cfg)
    pc = PathConfig(ceiling=cfg.pitch.fmax)
    local, fs, voiced = path_inputs(
        out["pitch_candidates_freq"], out["pitch_candidates_strength"], out["pitch_candidates_valid"],
        pc, local_intensity=_intensity(_local_peak(frames)),
    )
    return {"ct_fused": (windowed.contiguous(), 2 * n),
            "viterbi": (local, fs, voiced, pc.octave_jump_cost, pc.voiced_unvoiced_cost),
            "pitch_pre": pre_args}


def check_ct_fused(x, nfft: int, checks: Checks, tag: str) -> float:
    """Kernel E against its plain version on (F, n) frames x; returns the
    max abs error over both outputs."""
    import torch

    from voxtpu_torch.ops import ct_fused

    hk, ak = ct_fused.ct_fused_power_ac(x, nfft)
    hp, ap = ct_fused.ct_fused_power_ac_plain(x, nfft)
    if x.dtype == torch.float64:
        # tests/test_autocorr.py:148-152: the half spectrum over its largest
        # value at rtol 1e-9 / atol 1e-12, the lags at rtol 1e-9 / atol 1e-9.
        scale = hp.abs().max()
        checks.close(f"ct_fused half / max [{tag}]", hk / scale, hp / scale, 1e-9, 1e-12)
        checks.close(f"ct_fused ac [{tag}]", ak, ap, 1e-9, 1e-9)
    else:
        # Per frame, relative to the frame's largest value (CT_FUSED_F32_TOL).
        for name, k, p in (("half", hk, hp), ("ac", ak, ap)):
            scale = p.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
            checks.close(f"ct_fused {name} / frame max [{tag}]", k / scale, p / scale, 0.0, CT_FUSED_F32_TOL)
    return max(float((hk - hp).abs().max()), float((ak - ap).abs().max()))


def viterbi_edge_cases(dt, dev) -> list:
    """Kernel F's edge inputs, [(name, local, freq, voiced)] on dev, as
    `path_inputs` builds them (freq 1.0 where a candidate is unvoiced, local
    -inf on 10% of the lanes, strengths quantised to 0.1 so that totals
    tie), seeded: an all -inf frame; NaN scores; exact ties (equal scores,
    three frequencies); every frame unvoiced; voiced and unvoiced frames in
    turn; C = 1, 2, 3, 5 (a lane of each candidate's 4 with no previous
    candidate to take), 32, 33 and 128; F = 1, 2 and 3, and F - 1 steps at
    the ring's depth and one on either side; B = 16 recordings of one
    launch."""
    import torch

    from voxtpu_torch.ops.viterbi import launch_config

    rng = np.random.default_rng(11)

    def gen(B, F, C, voiced_p=0.7):
        voiced = rng.random((B, F, C)) < voiced_p
        freq = np.where(voiced, rng.uniform(60.0, 600.0, (B, F, C)), 1.0)
        local = np.round(rng.uniform(0.0, 1.0, (B, F, C)), 1)
        local[rng.random((B, F, C)) < 0.1] = -np.inf
        return local, freq, voiced

    cases = []
    local, freq, voiced = gen(1, 300, 33)
    local[0, 100] = -np.inf
    cases.append(("an all -inf frame", local, freq, voiced))
    local, freq, voiced = gen(1, 300, 33)
    local[0, 50:60, ::3] = np.nan
    cases.append(("NaN scores", local, freq, voiced))
    local, freq, voiced = gen(1, 300, 33, voiced_p=1.0)
    local[:] = 0.5
    freq = rng.choice([100.0, 200.0, 400.0], freq.shape)
    cases.append(("exact ties", local, freq, voiced))
    local, freq, voiced = gen(1, 300, 33, voiced_p=0.0)
    cases.append(("every frame unvoiced", local, freq, voiced))
    local, freq, voiced = gen(1, 300, 33)
    voiced[:] = (np.arange(300) % 2 == 0)[None, :, None]
    freq = np.where(voiced, rng.uniform(60.0, 600.0, freq.shape), 1.0)
    cases.append(("voiced and unvoiced in turn", local, freq, voiced))
    for C in (1, 2, 3, 5, 32, 33, 128):
        cases.append((f"C = {C}", *gen(2, 200, C)))
    ring = launch_config(1, 2, 33, dt)
    depth = ring.stages * ring.per  # records the ring holds
    for F in (1, 2, 3, depth, depth + 1, depth + 2):
        cases.append((f"F = {F} ({F - 1} steps, ring depth {depth})", *gen(1, F, 33)))
    cases.append(("B = 16 recordings", *gen(16, 120, 33)))
    return [(name, torch.as_tensor(lo, dtype=dt, device=dev), torch.as_tensor(fr, dtype=dt, device=dev),
             torch.as_tensor(vo, device=dev)) for name, lo, fr, vo in cases]


def check_viterbi_edges(checks: Checks, dev) -> None:
    """Kernel F on `viterbi_edge_cases` against its plain version, paths
    equal, in both dtypes; and in chunks of frame steps (`VITERBI_CHUNKS`,
    through `viterbi._launch`) on the B = 16, C = 128 and ring-depth cases,
    each chunk's chain carrying its scores to the next."""
    import torch

    from voxtpu_torch.ops import viterbi
    from voxtpu_torch.viterbi import PathConfig

    pc = PathConfig()
    ojc, vuc = pc.octave_jump_cost, pc.voiced_unvoiced_cost
    for dt in (torch.float64, torch.float32):
        dname = "f64" if dt == torch.float64 else "f32"
        for name, local, freq, voiced in viterbi_edge_cases(dt, dev):
            pk = viterbi.viterbi_path(local, freq, voiced, ojc, vuc)
            pp = viterbi.viterbi_path_plain(local, freq, voiced, ojc, vuc)
            shape = " x ".join(map(str, local.shape))
            checks.equal(f"viterbi path [{name}, {shape}, {dname}]", pk, pp)
            Fv = local.shape[1]
            if name.startswith(("B = 16", "C = 128", "F = ")) and Fv > 2:
                for steps in sorted({k for k in VITERBI_CHUNKS if k < Fv - 1} | {Fv - 2}):
                    pc_ = viterbi._launch(local, freq, voiced, ojc, vuc, steps=steps)
                    checks.equal(f"viterbi path [{name}, {shape}, {dname}, chunks of {steps} steps]", pc_, pp)


# Full-degree LPC rows that `check_orders` holds kernel C to its plain
# version on at N = 64 and 128.
ORDER_LPC_ROWS = 8

# Frame steps a chunk for `check_viterbi_edges`: one step, a ring stage,
# across the ring's depth, and more.
VITERBI_CHUNKS = (1, 2, 15, 17, 64)


def check_orders(checks: Checks, dev) -> None:
    """Kernels B, C and P at N = 33, 64 and 128 (ORDER_NS, orders 32-127),
    each against its plain version, in both dtypes: B on 64 noisy frames of
    2205 samples of the recording at `burg_tol`; C at `roots_tol` with
    count and status equal, on `roots_order_cases` at each N and on those
    frames' polynomials (as `roots_inputs` builds them; full degree, every
    deflation round), all 64 at N = 33 and the first `ORDER_LPC_ROWS` at N
    = 64 and 128 (the plain version's rounds are Python loops over the
    coefficients, about 12 s a call at degree 100 on an H100). At N = 64
    and 128 such rows do not settle in 20 Laguerre steps: the kernel and
    the plain version agree there because they run the same operations on
    the card's libm (the plain version on the CPU, another libm, parts from
    both); and P on
    each N's polynomials and C's roots of them and on their
    `polish_edge_cases`, bit for bit (`check_polish`)."""
    import torch

    from voxtpu_torch.ops import burg, find_roots

    for dt in (torch.float64, torch.float32):
        dname = "f64" if dt == torch.float64 else "f32"
        x = burg_large_frames(2205, 64, dt, dev)
        for N in ORDER_NS:
            tag = f"order {N - 1}, N = {N}, {dname}"
            ck, sk = burg.burg(x, N - 1)
            cp, sp = burg.burg_plain(x, N - 1)
            checks.close(f"burg coeffs [{tag}]", ck, cp, *burg_tol(dt))
            checks.equal(f"burg status [{tag}]", sk, sp)
            lpc = roots_inputs(x, N - 1)
            rk = find_roots.find_roots(*lpc)
            check_polish((*lpc, rk[0], rk[1]), checks, tag)
            _, re_, im_ = next(case for case in roots_order_cases(np.float64 if dt == torch.float64 else np.float32)
                               if case[0] == f"N = {N}")
            cases = [("roots_order_cases", (torch.as_tensor(re_, device=dev), torch.as_tensor(im_, device=dev)))]
            keep = len(lpc[0]) if N == ORDER_NS[0] else ORDER_LPC_ROWS
            cases.append((f"{keep} LPC rows", tuple(c[:keep].contiguous() for c in lpc)))
            for rows, cc in cases:
                rk, rp = find_roots.find_roots(*cc), find_roots.find_roots_plain(*cc)
                for part, k, p in zip(("re", "im"), rk, rp):
                    checks.close(f"roots {part} [{tag}, {rows}]", k, p, *roots_tol(dt))
                checks.equal(f"roots count and status [{tag}, {rows}]", torch.stack(rk[2:]), torch.stack(rp[2:]))


def check_high_order_path(head: np.ndarray, cfg, checks: Checks, dev) -> None:
    """`analyze` at LPC order 40 (`--n-coeffs 40`) in float64 on the card
    against the plain CPU path over `head`; and order 127 through the
    formant stage on the card with a resonance buffer of 127 (the path's
    holds 32, lib.rs:26), so that kernel D takes R = 127 rows, bit for bit
    against its plain scan.

    At order 40 the formants move by more than the slice test's tolerances
    when the input moves by one ulp: the CPU path itself does (8.3e-4 Hz in
    the frequencies, 4.4e-3 in the bandwidths over the first 2 s, measured
    on the CPU with this function's inputs), as Burg's sums and the roots'
    libm calls round a few ulps apart on the card and the CPU. So the
    formants are held to twice the CPU path's own spread between `head` and
    its two one-ulp neighbours, measured here; every other key to the
    slice test's tolerances."""
    import torch

    from voxtpu_torch.formants import formant_candidates
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops import formant_scan
    from voxtpu_torch.pipeline import analyze

    c40 = dataclasses.replace(cfg, formant=dataclasses.replace(cfg.formant, n_coeffs=40))
    cpu = analyze(torch.as_tensor(head), c40)
    spread = {"formant_freqs": 0.0, "formant_bws": 0.0}
    for nudged in (np.nextafter(head, np.inf), np.nextafter(head, -np.inf)):
        near = analyze(torch.as_tensor(nudged), c40)
        spread = {k: max(v, float((near[k] - cpu[k]).abs().max())) for k, v in spread.items()}
    print(f"  order 40, the CPU path's spread at one ulp of its input: {spread}")
    compare_slice("order 40 f64 card vs cpu", analyze(torch.as_tensor(head, device=dev), c40), cpu, cfg.sample_rate,
                  checks, formant_atol={k: 2 * v for k, v in spread.items()})
    frames = frame_signal(torch.as_tensor(head, device=dev), cfg.frame_len, cfg.hop)
    rf, rb, status = formant_candidates(frames, cfg.sample_rate, 127, max_resonances=127)
    est = torch.as_tensor(cfg.formant.estimates, dtype=rf.dtype, device=dev)
    eb = torch.full_like(est, cfg.formant.estimate_bandwidth)
    fk, bk = formant_scan.formant_scan(rf, rb, est, eb)
    fp, bp = formant_scan.formant_scan_plain(rf.cpu(), rb.cpu(), est.cpu(), eb.cpu())
    nres = int((rf > 0).sum(dim=1).max())
    checks.true("order 127 reaches kernel D with R = 127", rf.shape[1] == 127,
                f"({tuple(rf.shape)}; at most {nres} resonances live in a frame; {int(status.count_nonzero())} "
                f"frames with a nonzero status)")
    checks.equal(f"formant_scan freqs [order 127, R = 127, f64, {len(rf)} frames]", fk.cpu(), fp)
    checks.equal(f"formant_scan bws [order 127, R = 127, f64, {len(rf)} frames]", bk.cpu(), bp)


def check_new_kernels(args: dict, checks: Checks, label: str) -> dict:
    """Kernels E and F against their plain versions on the same inputs, for
    one dtype. Returns {kernel: max_abs_err}."""
    import torch

    from voxtpu_torch.ops import viterbi

    x, nfft = args["ct_fused"]
    tag = f"{label}, {'f64' if x.dtype == torch.float64 else 'f32'}"
    errs = {"ct_fused": check_ct_fused(x, nfft, checks, tag)}

    # Paths bit-identical, as the path calls the kernel; one recording is
    # also split into 16 recordings of one launch (its first 16 * (F // 16)
    # frames).
    local, fs, voiced, ojc, vuc = args["viterbi"]
    cases = [(tuple(local.shape), (local, fs, voiced))]
    if local.dim() == 2:
        B, Fb = CORPUS_FILES, local.shape[0] // CORPUS_FILES
        cases.append(((B, Fb, local.shape[1]),
                      [t[: B * Fb].reshape(B, Fb, -1).contiguous() for t in (local, fs, voiced)]))
    err = 0.0
    for shape, inputs in cases:
        pk = viterbi.viterbi_path(*inputs, ojc, vuc)
        pp = viterbi.viterbi_path_plain(*inputs, ojc, vuc)
        checks.equal(f"viterbi path [{tag}, {' x '.join(map(str, shape))}, one launch]", pk, pp)
        err = max(err, float((pk - pp).abs().max()))
    errs["viterbi"] = err
    return errs


def check_path_kernels(label: str, frames64, cfg, outs: dict, checks: Checks,
                       file_len: int | None = None) -> tuple[dict, dict]:
    """Every kernel a path launches against its plain version at that
    path's shapes, in float64 and float32. frames64: the path's float64
    frames, (F, n) or (B, F, n); outs: {dtype: the path's output in that
    dtype} (its candidates feed kernel F). Returns {dtype: {kernel: err}}
    and {dtype: kernel D's run} (`check_kernels`)."""
    errs, scans = {}, {}
    for dt, out in outs.items():
        frames = frames64.to(dt)
        print(f"kernels vs plain, {label}, {dt}:")
        errs[dt], scans[dt] = check_kernels(frames.reshape(-1, frames.shape[-1]), cfg, checks, label, file_len)
        if cfg.pitch.viterbi:
            errs[dt].update(check_new_kernels(bench_kernel_inputs(frames, out, cfg), checks, label))
    return errs, scans


def check_ct_fused_gate(checks: Checks, dev) -> None:
    """Kernel E against its plain version at every frame length its shape
    gate admits, in both dtypes: seeded noise, E_GATE_FRAMES frames a
    length; in float32 at the lengths that are not powers of two also
    against the float64 FFT per frame (CT_FUSED_F32_TOL). The gate must
    admit the 161 multiples of 128 up to 20,608 and refuse 20,736 in both
    (voxtpu's), and each length must launch E."""
    import torch

    from voxtpu_torch.ops import ct_fused

    gen = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float64, torch.float32):
        dname = "f64" if dt == torch.float64 else "f32"
        admitted = [n for n in range(128, 24000, 128) if ct_fused.ct_fused_supported(n, 2 * n, dt)]
        checks.true(f"ct_fused gate admits the multiples of 128 from 128 to 20608 in {dt}",
                    admitted == list(range(128, 20608 + 1, 128)) and not ct_fused.ct_fused_supported(20736, 41472, dt),
                    f"({len(admitted)}: {admitted[0]} .. {admitted[-1]})")
        before = ct_fused.ct_fused_power_ac.launches
        for n in admitted:
            frames = E_GATE_FRAMES["pow2" if n & (n - 1) == 0 else "other"]
            x = torch.randn((frames, n), generator=gen, dtype=dt, device=dev)
            tag = f"gate, n={n}, {ct_fused.ct_fused_layout(n, dt)}, {dname}"
            check_ct_fused(x, 2 * n, checks, tag)
            if dt == torch.float32 and n & (n - 1):
                he, ae = ct_fused.ct_fused_power_ac(x, 2 * n)
                h64, a64 = f64_transform(x, 2 * n)
                close_per_frame(f"ct_fused half vs float64 fft [{tag}]", he, h64, CT_FUSED_F32_TOL, checks)
                close_per_frame(f"ct_fused ac vs float64 fft [{tag}]", ae, a64, CT_FUSED_F32_TOL, checks)
        launched = ct_fused.ct_fused_power_ac.launches - before
        want = len(admitted) + (sum(1 for n in admitted if n & (n - 1)) if dt == torch.float32 else 0)
        checks.true(f"ct_fused launched at each of the {len(admitted)} lengths in {dt}",
                    launched == want, f"({launched} launches, {want} expected)")


def bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """The least ms for the work: the larger of its bytes over the memory
    rate and its operations over the compute rate (ops_s: operations over
    their rate, in seconds)."""
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_bytes, ops_s) * 1e3, "bytes" if t_bytes >= ops_s else "operations")


def pitch_pre_bound(args) -> tuple[float, str]:
    """Kernel G's bound at its arguments: it reads the (B, n) lags and the
    (n,) table once and writes (B, 2n) + (B, bi) values and (B, bi) flags;
    about 4 operations a lag for the max and the normalisation and 12 a lag
    below bi for the maxima, the frequency and the band."""
    ac, hl, bi = args[:3]
    B, n = ac.shape
    isz = ac.element_size()
    nbytes = B * n * isz + n * isz + B * (2 * n + bi) * isz + B * bi
    ops = B * (4 * n + 12 * bi)
    return bound(nbytes, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))


def formant_scan_bound(rf, L: int) -> tuple[float, str]:
    """Kernel D's bound in float32 at (F, R) resonances and L estimates:
    per frame, min(L, 6) nearest-match scans over R values (3 operations
    each) and about 200 for the slot logic; it reads the rows once and
    writes (F, L) x 2."""
    F, R = rf.shape
    return bound(F * R * 2 * 4 + F * L * 2 * 4, F * (min(L, 6) * R * 3 + 200) / F32_OPS_S)


def polish_bound(args, iters: int = 2, passes_per_iter: int = 1) -> tuple[float, str]:
    """Kernel P's bound at its arguments: it reads the (F, N) coefficient
    and root pairs once and writes (F, N) pairs; each live slot (a root
    that is not 0 + 0i; the others only copy) does 1 + passes_per_iter x
    iters Horner passes of N - 1 steps and iters Newton steps. One pass an
    iteration is the least this function needs (each point evaluated once,
    as the kernel does); the plain version makes two."""
    c_re, _, z_re, z_im = args
    F, N = c_re.shape
    live = int(((z_re != 0) | (z_im != 0)).sum())
    # Counted from csrc/polish.cu: a Horner step does 8 operations for p',
    # 1 negation, 4 double-T products of 22 and 2 double-T sums of 11 (p z),
    # 2 for the coefficients (+ 0) and 2 double-T sums of 10 (+ c): 141; a
    # pass 4 more (the top coefficient, the collapse). A Newton step does 23
    # beside its passes (den, dz, the finite and size test, the step, |p|^2
    # and its compare); a slot 5 more (the zero test, |p(z0)|^2).
    per_slot = (1 + passes_per_iter * iters) * (141 * (N - 1) + 4) + 23 * iters + 5
    isz = c_re.element_size()
    return bound(6 * F * N * isz, live * per_slot / (F32_OPS_S if isz == 4 else F64_OPS_S))


def refine_bound(args, stats) -> tuple[float, str]:
    """Kernel A's bound at its arguments. Operations: 11 a tap-side (the
    tap's angle, 2; sin times sign over it, 2; the taper's argument, cos and
    0.5 + 0.5 c, 4; the coefficient, 1; the product and the sum, 2) over the
    tap-sides that the live candidates' evaluations summed (`stats`, as the
    kernel counts them) and those of the one evaluation each masked-off
    candidate makes at v0. Bytes: the columns of each row that its taps
    reach at the starts (from the lowest left tap to the highest right tap
    over the row's candidates), x0, valid and the two outputs."""
    import torch

    y, x0, valid, offset, max_depth, T = args
    B, L = y.shape
    isz = y.element_size()

    def depth(x):
        return torch.clamp(offset + torch.floor(x).long() + 1, min=0).clamp(max=min(max_depth, T))

    v0 = x0 - 1.0 + (1.0 - 0.6180339887498948) * 2.0
    dead_taps = int((2 * (depth(v0) + 1))[~valid].sum())
    base = offset + torch.floor(x0).long()
    md = depth(x0)
    lo = torch.clamp(base + 1 - md, 0, L - 1).amin(dim=1)
    hi = torch.clamp(base + md, 0, L - 1).amax(dim=1)
    columns = int((hi - lo + 1).sum())
    nbytes = columns * isz + x0.numel() * (isz + 1) + 2 * x0.numel() * isz
    ops = 11.0 * (stats[1] + dead_taps)
    return bound(nbytes, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))


def burg_bound(x, p: int, cvt_s: float | None = None) -> tuple[float, str]:
    """Kernel B's bound at (F, n) frames and order p. It reads the frames
    once and writes (F, p) coefficients and F statuses. Each order i sums
    num and denum over n - i pairs in float64 (6 operations a pair) and,
    below p, updates n - i pairs in the frames' dtype (4), at the peak
    rates. With cvt_s, float -> double conversions a second, it also
    counts the 2 conversions a summed pair of float frames. They run on a
    pipe of their own, beside the float64 FMAs (tools/burg_rates.cu's
    cvt_with_dfma probe runs at the conversion rate), so the least time is
    the larger of the two, not their sum."""
    F, n = x.shape
    isz = x.element_size()
    summed = sum(n - i for i in range(1, p + 1)) * F
    updated = sum(n - i for i in range(1, p)) * F
    nbytes = F * n * isz + F * (p * isz + 4)
    ops_s = 6.0 * summed / F64_OPS_S + 4.0 * updated / (F32_OPS_S if isz == 4 else F64_OPS_S)
    if cvt_s is not None and isz == 4:
        ops_s = max(ops_s, 2.0 * summed / cvt_s)
    return bound(nbytes, ops_s)


def rate_probes_build(nvcc: str) -> tuple[list[str], Path]:
    """The nvcc command that builds tools/burg_rates.cu's probes into a
    library under build/, and that library's path."""
    lib = ROOT / "build" / "burg_rates" / "libburg_rates.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-o", str(lib), str(RATES_SRC)], lib


def probe_rates(lib_path: Path, names, card: str) -> dict:
    """The named probes' lane-operations a clock an SM on card 0 (RATE_PROBES),
    from each probe's time over 3 runs after one warm-up (CUDA events) and
    the SM clock that thread 0 of block 0 saw (clock64 against the global
    timer); "sms", the card's SM count."""
    import ctypes

    import torch

    lib = ctypes.CDLL(str(lib_path))
    lib.burg_rates_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.burg_rates_probe.restype = ctypes.c_longlong
    lib.burg_rates_error.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = sms * 16, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.float32, device=dev)
    stamp = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {"sms": sms}
    for name in names:
        def run():
            return lib.burg_rates_probe(RATE_PROBES[name], blocks, threads, iters, out.data_ptr(), stamp.data_ptr(),
                                        stream)

        per_thread = run()
        err = lib.burg_rates_error()
        if per_thread < 0 or err != 0:
            raise RuntimeError(f"probe {name}: CUDA error {err}")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        runs = 3
        start.record()
        for _ in range(runs):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / runs
        clocks, ns = (int(v) for v in stamp.cpu())
        ghz = clocks / ns
        total = per_thread * blocks * threads
        per_clock_sm = total / (ms * 1e-3 * ghz * 1e9) / sms
        rates[name] = {"per_clock_sm": per_clock_sm, "ms": ms, "sm_ghz": ghz, "operations": total}
        print(f"rate {name}: {per_clock_sm:.2f} a clock an SM ({total:.3e} in {ms:.3f} ms at {ghz:.3f} GHz, "
              f"{sms} SMs) [{card}]", flush=True)
    return rates


def ct_fused_bound(x, nfft: int) -> tuple[float, str]:
    """Kernel E's bound at (F, n) frames x: two transforms of nfft points
    whose time side is real (the input, and the lags of a real even
    spectrum): 2.5 nfft log2 nfft operations each, half a complex radix-2
    transform's 5 nfft log2 nfft, and the power, 3 operations on each of
    the nfft / 2 + 1 bins; it reads x once and writes (F, n/2 + 1) + (F, n)
    values. It counts the function's work, not the kernel's."""
    F, n = x.shape
    isz = x.element_size()
    ops = F * (2 * 2.5 * nfft * math.log2(nfft) + 3 * (nfft // 2 + 1))
    return bound(F * n * isz + F * (n // 2 + 1) * isz + F * n * isz, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))


def ct_fused_pfa_algo_ms(x, nfft: int) -> float:
    """The least ms for the tensor-core products of kernel E's prime-factor
    kernel at (F, n) frames x of a length that is not a power of two (n =
    N1 m, mh = (m + 1)/2), as the kernel issues them (csrc/ct_fused.cu): in
    each of steps 1 and 5, four real products of its mma tiles (float32
    m16n8k8 in three TF32 passes, float64 m8n8k4): N1/16 M tiles x
    ceil(mh/8) N tiles x ceil(mh/8) K tiles, or where mh fits one K tile
    (mh <= 8 in float32, 4 in float64) N1 / (kP/mhp x 16) packed tiles (mhp
    the power of two >= mh), at the dense TF32 (FP64) tensor-core rate. It
    says how far the kernel's DFTs are from the card's rate and is
    reported beside E's bound (`ct_fused_bound`, the function's work),
    never as it: the row FFTs, the split and the turns run on the CUDA
    cores beside them."""
    F, n = x.shape
    f32 = x.element_size() == 4
    kM, kN, kK, kP = (16, 8, 8, 8) if f32 else (8, 8, 4, 4)
    n1 = n & -n
    mh = (n // n1 + 1) // 2
    if mh <= kP:
        tiles = n1 // (kP // (1 << (mh - 1).bit_length()) * kM)
    else:
        tiles = n1 // kM * -(-mh // kN) * -(-mh // kK)
    ops = F * 2 * tiles * 4 * 2 * kM * kN * kK * (3 if f32 else 1)
    return ops / (TF32_TC_OPS_S if f32 else F64_TC_OPS_S) * 1e3


def cufft_power_ac(x, nfft: int):
    """Kernel E's function as torch.fft calls (cuFFT on the card): rfft,
    power, irfft. The yardstick beside E (`library_ms`); the port never
    calls it."""
    import torch

    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return power[:, ::2], torch.fft.irfft(power, n=nfft, dim=-1)[:, : x.shape[-1]]


def roots_bound(c_re) -> tuple[float, str]:
    """Kernel C's bound at (F, N) coefficients: N - 3 rounds of 20 Laguerre
    steps; a step evaluates p, p' and p'' over the live degree (3 complex
    multiply-adds, 24 operations, a coefficient) plus about 60 for the
    square root and the division. It reads the (F, N) coefficient pairs and
    writes (F, N - 1) root pairs, the counts and the statuses."""
    F, N = c_re.shape
    isz = c_re.element_size()
    degs = [N - 1 - r for r in range(max(N - 3, 0))]
    ops = F * 20 * sum(24 * d + 60 for d in degs)
    nbytes = F * N * 2 * isz + F * (N - 1) * 2 * isz + F * 8
    return bound(nbytes, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))


def viterbi_bound(local) -> tuple[float, str]:
    """Kernel F's bound at (F, C) or (B, F, C) local scores, the work the
    function needs: per frame step C^2 costs (division, log2, |.|, product,
    difference and compare: 6 operations); it reads local, freq and voiced
    once and writes the path. The pre-pass's records are this design's own
    traffic, not the function's: `viterbi_records_ms` times them apart."""
    shape = tuple(local.shape) if local.dim() == 3 else (1, *local.shape)
    B, Fv, Cv = shape
    isz = local.element_size()
    ops = B * Fv * Cv * Cv * 6
    nbytes = B * Fv * Cv * (2 * isz + 1) + B * Fv * 4
    return bound(nbytes, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))


def viterbi_records_ms(local) -> float:
    """The time to write kernel F's records (every frame step's, in
    whatever chunks) and read them back at HBM3's rate; chunks whose
    records stay in L2 can take less."""
    from voxtpu_torch.ops.viterbi import launch_config

    B, Fv, Cv = tuple(local.shape) if local.dim() == 3 else (1, *local.shape)
    return 2 * B * (Fv - 1) * launch_config(B, Fv, Cv, local.dtype).record / HBM_BYTES_S * 1e3


def kernel_bounds(cli: dict, bench: dict, refine_stats: tuple) -> dict:
    """Each kernel's bound in float32 at the inputs it is timed on (see
    KERNELS): bytes are each input read once and each output written once;
    operations are counted from this run's inputs, each arithmetic
    operation, division or cos as one; A's from the kernel's stats on the
    same inputs (`refine_bound`)."""
    rf, _, ef, _ = cli["formant_scan"]
    return {
        "refine": refine_bound(cli["refine"], refine_stats),
        "burg": burg_bound(*cli["burg"]),
        "find_roots": roots_bound(cli["find_roots"][0]),
        "formant_scan": formant_scan_bound(rf, ef.shape[0]),
        "ct_fused": ct_fused_bound(*bench["ct_fused"]),
        "viterbi": viterbi_bound(bench["viterbi"][0]),
        "pitch_pre": pitch_pre_bound(bench["pitch_pre"]),
        "polish": polish_bound(cli["polish"]),
    }


def knife_rtol(f0, sample_rate: float, base: float):
    """Per-frame f0/strength rtol: `base`, or 5e-3 where the refined lag sits
    within KNIFE of an integer (tests/test_traces_16k.py:64-76)."""
    import torch

    lag = torch.where(f0 > 0, sample_rate / f0, 0.0)
    return torch.where((lag - lag.round()).abs() < KNIFE, 5e-3, base)


def compare_slice(name, got: dict, want: dict, sample_rate: float, checks: Checks,
                  formant_atol: dict | None = None) -> None:
    """The CPU slice test's tolerances (tests/test_torch_pipeline.py);
    formant_atol: {key: atol} in place of them for the formant keys."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    for key in ("f0", "f0_strength"):
        rt = knife_rtol(want["f0"], sample_rate, 1e-5)
        err = (got[key] - want[key]).abs()
        nbad = int((err > 1e-8 + rt * want[key].abs()).sum())
        checks.true(f"{name} {key}", nbad == 0, f"max_abs_err {float(err.max()):.3e}, {nbad} outside")
    checks.close(f"{name} rms", got["rms"], want["rms"], 1e-12, 0.0)
    checks.close(f"{name} mfcc", got["mfcc"], want["mfcc"], 1e-9, 1e-9)
    for key, tol in (("formant_freqs", (1e-7, 1e-5)), ("formant_bws", (1e-6, 1e-4))):
        checks.close(f"{name} {key}", got[key], want[key], *((0.0, formant_atol[key]) if formant_atol else tol))
    checks.equal(f"{name} status", got["status"], want["status"])
    checks.equal(f"{name} hnr_db finite", torch.isfinite(got["hnr_db"]), torch.isfinite(want["hnr_db"]))


def frame_err(key, a, b, f0_64):
    """Per-frame |a - b| (max over a frame's values), on the CPU; the f0
    budget holds on frames voiced in float64 only."""
    import torch

    err = (a.cpu().double() - b.cpu().double()).abs()
    if err.dim() > 1:
        err = err.amax(dim=-1)
    return torch.where(f0_64.cpu() > 0, err, 0.0) if key == "f0" else err


def hold_budgets(label: str, out32: dict, out64: dict, plain_err, checks: Checks) -> None:
    """float32 against float64 on the card within BUDGETS; float64 is the
    only reference. Every frame over a budget on the card must be over it
    in the plain path too: plain_err(key, idx) gives the plain path's
    float32-against-float64 error at frames idx."""
    import torch

    for key, budget in BUDGETS.items():
        err = frame_err(key, out32[key], out64[key], out64["f0"])
        idx = (err > budget).nonzero().flatten()
        detail = f"max_abs_err {float(err.max()):.3e} (budget {budget:g}), {len(idx)} frames over"
        plain_over = torch.ones(len(idx), dtype=torch.bool)
        if len(idx):
            perr = plain_err(key, idx)
            plain_over = perr > budget
            detail += (f"; the plain path's float32 is over it on {int(plain_over.sum())} of them "
                       f"(max {float(perr.max()):.3e})")
            if not plain_over.all():
                detail += (f"; not on frames {idx[~plain_over].tolist()[:8]}: card err "
                           f"{err[idx][~plain_over].tolist()[:8]}, plain err {perr[~plain_over].tolist()[:8]}")
        checks.true(f"{label} f32 {key}", bool(plain_over.all()), detail)


def check_budgets(out32: dict, out64: dict, signal: np.ndarray, cfg, checks: Checks, label: str = "cli") -> None:
    """The CLI path's budgets (`hold_budgets`; or another path's, named by
    label, at its cfg), the plain CPU path looked up at the frames over a
    budget.

    float32 at the 2205/441 framing breaks the f0 budget in the plain
    version too (PERF.md). Pitch and MFCC are frame-local, so those frames
    alone run; the formant tracker carries its estimates from frame to
    frame, so the candidates of every frame up to the last one looked up
    run, tracked by kernel D (bit-exact with its plain version, phase 3)."""
    import torch

    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops.formant_scan import formant_scan
    from voxtpu_torch.pipeline import analyze_frames

    dev = out32["f0"].device
    frames = frame_signal(torch.as_tensor(signal), cfg.frame_len, cfg.hop)

    def off(stage_cfg):
        return dataclasses.replace(stage_cfg, enabled=False)

    def plain(key, idx, dt):
        """The plain CPU path's (key, f0) at frames idx, in dtype dt."""
        if key != "formant_freqs":  # frame-local: those frames alone
            out = analyze_frames(frames[idx].to(dt), dataclasses.replace(cfg, formant=off(cfg.formant)))
            return out[key], out["f0"]
        sub = dataclasses.replace(cfg, pitch=off(cfg.pitch), mfcc=off(cfg.mfcc))
        out = analyze_frames(frames[: int(idx.max()) + 1].to(dt), sub, return_formant_candidates=True)
        est = torch.as_tensor(cfg.formant.estimates, dtype=dt, device=dev)
        freqs, _ = formant_scan(out["resonance_freqs"].to(dev), out["resonance_bws"].to(dev), est,
                                torch.full_like(est, cfg.formant.estimate_bandwidth))
        return freqs[idx.to(dev)], None

    def plain_err(key, idx):
        v32, _ = plain(key, idx, torch.float32)
        v64, f0_64 = plain(key, idx, torch.float64)
        return frame_err(key, v32, v64, f0_64)

    hold_budgets(label, out32, out64, plain_err, checks)


def plain_periodic(one: np.ndarray, tiles: int, cfg, dt, frames_total: int, dev) -> dict:
    """The plain CPU path's budget keys over `tiles` copies of `one`, in
    dtype dt, without running every frame on the CPU.

    len(one) is a whole number P of hops, so frame t and frame t + P hold
    the same samples. The frame-local stages (pitch candidates, resonances,
    MFCC) run in plain PyTorch on the CPU over the first P frames and are
    tiled to every frame; they hold no state across frames, so this equals
    running them over all frames. The stages with a carry run over all
    frames: the path search as its plain DP on the CPU, the formant tracker
    as kernel D on the card (bit-exact with its plain version, phase 6)."""
    import torch

    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops.formant_scan import formant_scan
    from voxtpu_torch.pipeline import _intensity, _local_peak, analyze_frames
    from voxtpu_torch.viterbi import PathConfig, pitch_path

    n, hop = cfg.frame_len, cfg.hop
    P, rem = divmod(len(one), hop)
    if rem or tiles < 2:
        raise ValueError("plain_periodic needs a recording of a whole number of hops, tiled")
    head = np.tile(one, tiles)[: (P - 1) * hop + n]
    frames = frame_signal(torch.as_tensor(head, dtype=dt), n, hop)  # the first P frames, CPU
    inner = dataclasses.replace(cfg, pitch=dataclasses.replace(cfg.pitch, viterbi=False))
    out = analyze_frames(frames, inner, return_formant_candidates=True)
    reps = -(-frames_total // P)

    def tile(v):
        return v.repeat((reps,) + (1,) * (v.dim() - 1))[:frames_total]

    est = torch.as_tensor(cfg.formant.estimates, dtype=dt, device=dev)
    freqs, _ = formant_scan(tile(out["resonance_freqs"]).to(dev), tile(out["resonance_bws"]).to(dev), est,
                            torch.full_like(est, cfg.formant.estimate_bandwidth))
    f0, s0 = pitch_path(tile(out["pitch_candidates_freq"]), tile(out["pitch_candidates_strength"]),
                        tile(out["pitch_candidates_valid"]), PathConfig(ceiling=cfg.pitch.fmax),
                        local_intensity=_intensity(tile(_local_peak(frames))))
    return {"f0": f0, "f0_strength": s0, "formant_freqs": freqs.cpu(), "mfcc": tile(out["mfcc"])}


def check_health(label: str, out: dict, checks: Checks) -> None:
    """Finite outputs (hnr_db is -inf exactly where f0 == 0), status 0 on
    every frame, and the median f0 and F1 printed."""
    import torch

    for k, v in out.items():
        if v.is_floating_point():
            fin = torch.isfinite(v)
            if k == "hnr_db":
                checks.true(f"{label} hnr_db finite exactly where f0 > 0", bool((fin == (out["f0"] > 0)).all()))
                fin = fin | (v == -np.inf)
            checks.true(f"{label} {k} finite", bool(fin.all()))
    nz = int(out["status"].count_nonzero())
    checks.true(f"{label} status 0 on every frame", nz == 0, f"({nz} nonzero)")
    voiced = out["f0"] > 0
    print(f"  {label}: voiced frames {int(voiced.sum())} of {out['f0'].numel()}; median f0 "
          f"{float(out['f0'][voiced].median()):.2f} Hz, median F1 {float(out['formant_freqs'][..., 0].median()):.1f} Hz")


def trace_once(fn) -> dict:
    """One warm run of fn under torch.profiler, after one run in the
    profiler's warm-up step, each run between two idle pads of
    `PROFILE_PAD_S` (see there). From the trace alone: the device's busy
    time (union of its activities' intervals), the traced span (the run on
    the host, from its first op to the end of its device sync, pads left
    out) and so the idle share. The profiler's own host cost lengthens the
    launch gaps, so the idle share here is an upper bound. Returns
    {"busy_ms", "span_ms", "idle", "activities", "by_name": {activity name:
    [count, device us]}}."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_PAD_S)
            with record_function(RUN_ANNOTATION):
                fn()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
    events = prof.events()
    # Annotations (the run's and the step's) are no device work.
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    runs = [e for e in events if e.name == RUN_ANNOTATION and e.device_type == torch.autograd.DeviceType.CPU]
    if not device or len(runs) != 1:
        raise AssertionError(f"torch.profiler recorded {len(device)} device activities and {len(runs)} runs")
    busy, cur_start, cur_end = 0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        if cur_end is None or start > cur_end:
            busy += 0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = runs[0].time_range.elapsed_us()
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3, "idle": 1 - busy / span, "activities": len(device),
            "by_name": dict(by_name)}


def kernel_counts(trace: dict) -> dict:
    """{profiler name of each kernel (TRACED_ACTIVITIES): its activities in trace}."""
    return {act: sum(c for name, (c, _us) in trace["by_name"].items() if act in name)
            for _, act in TRACED_ACTIVITIES}


def profile_path(label: str, fn, card: str, want: dict, top: int | None = 12) -> dict:
    """`trace_once(fn)`, taken again while its kernels' counts
    (`kernel_counts`) differ from want, at most PROFILE_TRACES traces in all
    (see there); the last is returned, with "traces", the number taken.
    Prints its busy time, span, idle share, activities and the `top`
    activity names with the most device time (every name when None)."""
    for n in range(1, PROFILE_TRACES + 1):
        trace = trace_once(fn)
        got = kernel_counts(trace)
        if got == want:
            break
        off = {act: f"{c}, not {want[act]}" for act, c in got.items() if c != want[act]}
        print(f"  {label}: trace {n} held {off}, {trace['activities']} device activities; "
              f"{'taken again' if n < PROFILE_TRACES else 'no trace left'}")
    trace["traces"] = n
    busy, span = trace["busy_ms"], trace["span_ms"]
    print(f"profile, one warm float32 {label} [{card}]: device busy {busy:.3f} ms of a {span:.3f} ms traced "
          f"span, idle share {trace['idle']:.4f}; {trace['activities']} device activities (trace {n})")
    for name, (count, us) in sorted(trace["by_name"].items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:100]}")
    return trace


def corpus_block(one: np.ndarray, sr: float):
    """The corpus block's CORPUS_FILES recordings, each CORPUS_TILES tiles
    of `one` times a gain in [0.5, 2) with up to 1 s of tail cut
    (`default_rng(0)`): (recordings, their lengths, the zero-padded block)."""
    rng = np.random.default_rng(0)
    gains = rng.uniform(0.5, 2.0, CORPUS_FILES)
    trims = rng.integers(0, int(sr), CORPUS_FILES)
    recs = [g * np.tile(one, CORPUS_TILES)[: CORPUS_TILES * len(one) - t] for g, t in zip(gains, trims)]
    lengths = [len(r) for r in recs]
    block = np.zeros((CORPUS_FILES, max(lengths)))
    for b, r in enumerate(recs):
        block[b, : len(r)] = r
    return recs, lengths, block


def with_viterbi(cfg):
    """cfg with the Viterbi path search on (`--viterbi`)."""
    return dataclasses.replace(cfg, pitch=dataclasses.replace(cfg.pitch, viterbi=True))


@contextlib.contextmanager
def eager_polish():
    """The paths as they ran before kernel P: `roots.polish_roots` through
    the plain version's eager PyTorch ops on the card."""
    from voxtpu_torch.ops import polish

    kernel = polish.polish_roots
    polish.polish_roots = polish.polish_roots_plain
    try:
        yield
    finally:
        polish.polish_roots = kernel


def float_wav_bytes(x, sample_rate: float) -> bytes:
    """A mono 32-bit IEEE-float WAV (format 3), which keeps values above 1."""
    data = np.asarray(x, dtype="<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, int(sample_rate), int(sample_rate) * 4, 4, 32)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data)


def write_float_wav(path, x, sample_rate: float) -> None:
    with open(path, "wb") as f:
        f.write(float_wav_bytes(x, sample_rate))


def npz_tensors(path) -> dict:
    import torch

    with np.load(path) as z:
        return {k: torch.as_tensor(z[k]) for k in z.files}


def http_post(port: int, path: str, body: bytes = b"", timeout: float = 300.0) -> tuple[int, bytes, float]:
    """POST to the local server: (status, body, seconds on the host clock)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    return r.status, data, time.perf_counter() - t0


def http_get(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def response_features(data: bytes, fmt: str) -> dict:
    """A /analyze or /stream response's features as NumPy arrays: npz as
    written; JSON lists back to float32 (exact: each value was a float32),
    null (a non-finite value: hnr_db's -inf) back to -inf."""
    import io

    if fmt == "npz":
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}
    feats = json.loads(data)["features"]
    out = {}
    for k, v in feats.items():
        a = np.asarray(v, dtype=object)
        out[k] = np.where(a == None, -np.inf, a).astype(np.float64).astype(np.float32)  # noqa: E711
    return out


def bits_apart(got: dict, want: dict) -> dict:
    """{key: elements whose values differ in bits} (NaN equals NaN)."""
    out = {}
    for k, w in want.items():
        g = np.asarray(got[k]).astype(w.dtype)
        same = (g == w) | (np.isnan(g) & np.isnan(w)) if w.dtype.kind == "f" else g == w
        out[k] = int((~same).sum())
    return out


def over_budgets(got: dict, want: dict) -> dict:
    """{key: values over BUDGETS}: f0 on the frames voiced in `want`."""
    voiced = want["f0"] > 0
    out = {}
    for key, budget in BUDGETS.items():
        err = np.abs(got[key].astype(np.float64) - want[key].astype(np.float64))
        if key == "f0":
            err = np.where(voiced, err, 0.0)
        out[key] = int((~(err <= budget)).sum())
    return out


def serve_recordings(one: np.ndarray) -> tuple[list, list]:
    """SERVE_REQUESTS recordings of 1-8 tiles of `one` (2.8-22.7 s), each
    times a gain in [0.5, 2) (`default_rng(0)`), float32; and their tiles."""
    rng = np.random.default_rng(0)
    tiles = rng.integers(1, 9, SERVE_REQUESTS)
    gains = rng.uniform(0.5, 2.0, SERVE_REQUESTS)
    return [(g * np.tile(one, t)).astype(np.float32) for t, g in zip(tiles, gains)], tiles.tolist()


def check_serve(one: np.ndarray, sr: float, card: str, checks: Checks, run_counted, dev) -> dict:
    """Phase 11: `voxtpu_torch.serve` on device `dev` (see the module
    docstring). Returns the launches of each counted run and the phase's
    numbers."""
    import select
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from voxtpu_torch import cli
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.pipeline import CLI_DEFAULT_44K, _intensity, _local_peak, analyze, analyze_long, f0_outputs
    from voxtpu_torch.serve import ServeConfig, VoxServer, _jsonable, _Pending
    from voxtpu_torch.viterbi import PathConfig, pitch_path

    cfg = CLI_DEFAULT_44K
    srv = VoxServer(ServeConfig(port=0, window_ms=3, max_batch=8, bucket=1024, device=str(dev)))
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    _host, port = srv.start()
    print(f"server on the card: {srv.health()}; warmup() {warm_s:.2f} s (shapes (1, 64) and (8, 1024)) [{card}]")
    launches, numbers = {}, {"warmup_s": warm_s}
    try:
        # /analyze: 64 recordings from 8 client threads at once, half JSON, half npz.
        recs, tiles = serve_recordings(one)
        bodies = [float_wav_bytes(r, sr) for r in recs]
        fmts = ["json" if i % 2 == 0 else "npz" for i in range(SERVE_REQUESTS)]

        def post(i):
            return http_post(port, f"/analyze?format={fmts[i]}", bodies[i])

        def burst():
            t = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                res = list(pool.map(post, range(SERVE_REQUESTS)))
            return res, time.perf_counter() - t

        (results, wall), launches["burst"] = run_counted("serve, 64 /analyze requests", burst)
        stats = http_get(port, "/stats")
        audio = sum(len(r) for r in recs) / sr
        lat = sorted(s for _st, _d, s in results)
        numbers["burst"] = {
            "wall_s": wall, "requests_per_s": SERVE_REQUESTS / wall, "audio_s_per_s": audio / wall,
            "audio_s": audio, "p50_ms": 1e3 * lat[len(lat) // 2], "p95_ms": 1e3 * lat[int(0.95 * len(lat))],
            "batch_size_hist": stats["batch_size_hist"], "batches": stats["batches"],
            "shapes": stats["compiled_shapes"], "server_latency_ms": stats["latency_ms"],
            "device_time_s": stats["device_time_s"],
        }
        b = numbers["burst"]
        print(f"serve burst: {SERVE_REQUESTS} requests ({audio:.1f} s of audio, {SERVE_CLIENTS} clients) in "
              f"{wall:.3f} s = {b['requests_per_s']:.1f} requests/s, {b['audio_s_per_s']:.1f} audio-s/s; latency "
              f"p50 {b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms (client); batches {stats['batches']}, batch sizes "
              f"{stats['batch_size_hist']}, shapes {stats['compiled_shapes']}; device_time_s {stats['device_time_s']} "
              f"(CUDA events, summed over batches) [{card}]")
        checks.true("serve: every /analyze answered 200", all(st == 200 for st, _d, _s in results),
                    f"{[st for st, _d, _s in results if st != 200][:4]}")
        checks.true("serve: a batch of 2 or more coalesced", any(int(k) >= 2 for k in stats["batch_size_hist"]),
                    f"{stats['batch_size_hist']}")
        for name in ("pitch_pre", "refine", "burg", "find_roots", "formant_scan", "polish"):
            checks.true(f"serve burst: {name} launched", launches["burst"][name] >= 1, f"({launches['burst'][name]})")
        checks.true("serve burst: ct_fused and viterbi not launched",
                    launches["burst"]["ct_fused"] == 0 and launches["burst"]["viterbi"] == 0)

        # Each response against float32 `analyze` of its recording on the card.
        apart, over, values, served, worst = {}, {}, 0, {}, {}
        for i, (rec, (st, data, _s)) in enumerate(zip(recs, results)):
            if st != 200:
                continue
            got = response_features(data, fmts[i])
            want = {k: v.cpu().numpy() for k, v in analyze(torch.as_tensor(rec, device=dev), cfg).items()}
            served[i] = got
            checks.true(f"serve request {i}: keys and frames", got.keys() == want.keys()
                        and all(got[k].shape == want[k].shape for k in want), f"({got['f0'].shape}, {want['f0'].shape})")
            if got["f0"].shape != want["f0"].shape:
                continue
            checks.true(f"serve request {i}: status 0 on every frame, equal to analyze",
                        not got["status"].any() and not want["status"].any())
            for k, n in bits_apart(got, want).items():
                apart[k] = apart.get(k, 0) + n
                if n and want[k].dtype.kind == "f":
                    d = np.abs(got[k].astype(np.float64) - want[k])
                    worst[k] = max(worst.get(k, 0.0), float(d[np.isfinite(d)].max(initial=0.0)))
            for k, n in over_budgets(got, want).items():
                over[k] = over.get(k, 0) + n
            values += sum(v.size for v in want.values())
        numbers["bits_apart"], numbers["over_budgets"], numbers["max_abs_err"] = apart, over, worst
        print(f"serve responses vs float32 analyze on the card: {sum(apart.values())} of {values} values not "
              f"bit-equal, by key {apart}, largest difference by key {worst}; over BUDGETS {over} [{card}]")
        checks.true("serve responses within BUDGETS of analyze", not any(over.values()), f"{over}")

        # One dispatch under the sync check: stack, copy, analyze, copy back, no host wait.
        frames = [(len(r) - cfg.frame_len) // cfg.hop + 1 for r in recs]
        Fp = cli._bucket_target(frames[0], srv.cfg.bucket)
        key = (srv._config(sr, dict(srv.cfg.defaults)), Fp, cfg.frame_len)
        items = [_Pending(np.ascontiguousarray(r[: (F - 1) * cfg.hop + cfg.frame_len]), F)
                 for r, F in zip(recs, frames) if cli._bucket_target(F, srv.cfg.bucket) == Fp][:2]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending = srv.batcher._dispatch(key, items)
            host_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        errors = [it.error for it in items if it.error]
        checks.true("serve: one dispatch ran with no host sync (set_sync_debug_mode('error'))",
                    pending is not None and not errors, errors[0][-1500:] if errors else "")
        if pending is not None:
            srv.batcher._drain(pending)
            dev_s = sum(t.seconds() for t in pending[5])
            numbers["dispatch"] = {"host_ms": 1e3 * host_s, "device_ms": 1e3 * dev_s, "recordings": len(items)}
            print(f"serve dispatch of {len(items)} recording(s) at (B, Fp) = ({len(items)}, {Fp}): host "
                  f"{1e3 * host_s:.2f} ms to stack and launch, device {1e3 * dev_s:.2f} ms [{card}]")

        # Warm single-request latency, and the share of it spent encoding JSON.
        i1 = tiles.index(4) if 4 in tiles else 0
        lat1 = sorted(http_post(port, "/analyze", bodies[i1])[2] for _ in range(9))
        feats = served.get(i1) or response_features(http_post(port, "/analyze?format=npz", bodies[i1])[1], "npz")
        enc = []
        for _ in range(9):
            t0 = time.perf_counter()
            json.dumps({"features": {k: _jsonable(v) for k, v in feats.items()}}).encode()
            enc.append(time.perf_counter() - t0)
        single_ms, json_ms = 1e3 * lat1[4], 1e3 * statistics.median(enc)
        numbers["single"] = {"latency_ms": single_ms, "json_ms": json_ms, "json_share": json_ms / single_ms,
                             "audio_s": len(recs[i1]) / sr, "frames": int(feats["f0"].shape[0])}
        print(f"serve, one warm request ({len(recs[i1]) / sr:.1f} s, {feats['f0'].shape[0]} frames, JSON): median of 9 "
              f"{single_ms:.2f} ms; JSON encoding {json_ms:.2f} ms = {100 * json_ms / single_ms:.1f}% of it [{card}]")

        # viterbi=1: the path search on the card over the trimmed candidates.
        iv = tiles.index(3) if 3 in tiles else 0
        (st, data, _s), launches["viterbi"] = run_counted(
            "serve, one viterbi=1 request", lambda: http_post(port, "/analyze?viterbi=1&format=npz", bodies[iv]))
        got = response_features(data, "npz")
        x = torch.as_tensor(recs[iv], device=dev)
        peak = _local_peak(frame_signal(x, cfg.frame_len, cfg.hop))
        cand = [torch.as_tensor(got[k], device=dev) for k in
                ("pitch_candidates_freq", "pitch_candidates_strength", "pitch_candidates_valid")]
        want = {k: v.cpu().numpy() for k, v in f0_outputs(*pitch_path(
            *cand, PathConfig(ceiling=cfg.pitch.fmax), local_intensity=_intensity(peak))).items()}
        vapart = bits_apart(got, want)
        checks.true("serve viterbi=1: f0, f0_strength, hnr_db bit for bit with pitch_path on the card",
                    st == 200 and not any(vapart.values()), f"({st}, {vapart})")
        checks.true("serve viterbi=1: kernel F launched", launches["viterbi"]["viterbi"] >= 1,
                    f"({launches['viterbi']['viterbi']})")

        # A 16 kHz request at 2048/512 (frame_ms=128, hop_ms=32): kernel E.
        x16 = np.interp(np.arange(0, len(one) * 4 * 16000 / sr) * sr / 16000, np.arange(len(one) * 4),
                        np.tile(one, 4)).astype(np.float32)
        (st, data, _s), launches["flagship_16k"] = run_counted(
            "serve, one 16 kHz request at 2048/512",
            lambda: http_post(port, "/analyze?frame_ms=128&hop_ms=32&format=npz", float_wav_bytes(x16, 16000.0)))
        got = response_features(data, "npz")
        c16 = cli.build_analysis_config(16000.0, frame_ms=128.0, hop_ms=32.0)
        want = {k: v.cpu().numpy() for k, v in analyze(torch.as_tensor(x16, device=dev), c16).items()}
        ok16 = st == 200 and got["f0"].shape == want["f0"].shape
        o16 = over_budgets(got, want) if ok16 else {}
        checks.true(f"serve 16 kHz {c16.frame_len}/{c16.hop}: frames equal analyze and within BUDGETS",
                    ok16 and not any(o16.values()), f"({st}, {o16}, {bits_apart(got, want) if ok16 else ''})")
        checks.true("serve 16 kHz 2048/512: kernel E launched", launches["flagship_16k"]["ct_fused"] >= 1,
                    f"({launches['flagship_16k']['ct_fused']})")

        # Two /stream sessions over the whole 356.9 s signal: f32le, 1 MiB appends, 512-frame chunks.
        signal32 = np.tile(one, TILES).astype(np.float32)
        pcm = signal32.tobytes()

        def stream(open_q):
            st, d, _s = http_post(port, f"/stream/open?{open_q}")
            if st != 200:
                raise RuntimeError(f"/stream/open: {st} {d[:300]!r}")
            sid = json.loads(d)["session"]
            parts, t = [], time.perf_counter()
            for i in range(0, len(pcm), 1 << 20):
                st, d, _s = http_post(port, f"/stream/append?session={sid}&format=npz", pcm[i : i + (1 << 20)])
                if st != 200:
                    raise RuntimeError(f"/stream/append: {st} {d[:300]!r}")
                parts.append(response_features(d, "npz"))
            st, d, _s = http_post(port, f"/stream/close?session={sid}&format=npz")
            if st != 200:
                raise RuntimeError(f"/stream/close: {st} {d[:300]!r}")
            tail = response_features(d, "npz")
            wall = time.perf_counter() - t
            vit = {k[len("viterbi_"):]: tail.pop(k) for k in list(tail) if k.startswith("viterbi_")}
            parts = [p for p in parts + [tail] if p]  # an append that completes no chunk has no features
            feats = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            return feats, vit, wall

        xs = torch.as_tensor(signal32, device=dev)
        (feats, _vit, wall1), launches["stream"] = run_counted(
            "serve, /stream session", lambda: stream("rate=44100&chunk_frames=512"))
        want = {k: v.cpu().numpy() for k, v in analyze_long(xs, cfg, chunk_frames=512).items()}
        sapart = bits_apart(feats, want) if feats.keys() == want.keys() and feats["f0"].shape == want["f0"].shape \
            else {"keys or frames": -1}
        checks.true(f"serve /stream: {want['f0'].shape[0]} frames bit for bit with analyze_long(chunk_frames=512)",
                    not any(sapart.values()), f"{sapart}")
        (_feats2, vit, wall2), launches["stream_viterbi"] = run_counted(
            "serve, /stream session with viterbi=1", lambda: stream("rate=44100&chunk_frames=512&viterbi=1"))
        vwant = analyze_long(xs, with_viterbi(cfg), chunk_frames=512)
        vwant = {k: vwant[k].cpu().numpy() for k in ("f0", "f0_strength", "hnr_db")}
        svapart = bits_apart(vit, vwant) if vit.keys() >= vwant.keys() else {"keys": -1}
        checks.true("serve /stream viterbi=1 close: bit for bit with pitch_path over analyze_long's candidates",
                    not any(svapart.values()), f"{svapart}")
        checks.true("serve /stream viterbi=1 close: kernel F launched", launches["stream_viterbi"]["viterbi"] >= 1)
        secs = len(signal32) / sr
        numbers["stream"] = {"audio_s": secs, "wall_s": [wall1, wall2], "audio_s_per_s": [secs / wall1, secs / wall2]}
        print(f"serve /stream: {secs:.1f} s of audio in {wall1:.3f} s = {secs / wall1:.1f} audio-s/s; with viterbi=1 "
              f"{wall2:.3f} s = {secs / wall2:.1f} audio-s/s (1 MiB appends, npz, 512-frame chunks) [{card}]")
        stats = http_get(port, "/stats")
        numbers["device_time_s"] = stats["device_time_s"]
        print(f"serve /stats after the phase: device_time_s {stats['device_time_s']}, requests {stats['requests']}, "
              f"batches {stats['batches']}, stream_chunks {stats['stream_chunks']}, latency {stats['latency_ms']} "
              f"[{card}]")

        # The command a user runs: a new process, one request, SIGINT.
        proc = subprocess.Popen([sys.executable, "-m", "voxtpu_torch", "serve", "--port", "0", "--device", str(dev)],
                                cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            ready = select.select([proc.stdout], [], [], 300)[0]
            line = proc.stdout.readline() if ready else ""
            up_s = time.perf_counter() - t0
            if not line.startswith("voxtpu serving on http://"):
                raise RuntimeError(f"python -m voxtpu_torch serve printed {line!r}")
            cport = int(line.split()[3].rsplit(":", 1)[1])
            st, data, _s = http_post(cport, "/analyze", bodies[i1])
            ref = http_post(port, "/analyze", bodies[i1])[1]
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        same = st == 200 and json.loads(data) == json.loads(ref)
        apart = "" if same or st != 200 else f" ({bits_apart(response_features(data, 'json'), response_features(ref, 'json'))})"
        print(f"python -m voxtpu_torch serve: serving after {up_s:.1f} s (process start, CUDA init, warm-up); one "
              f"request {st}, {'equal to' if same else 'NOT equal to'} the in-process server's answer{apart}; exit "
              f"{rc} on SIGINT; stderr: {proc.stderr.read().strip()[-400:]}")
        checks.true("python -m voxtpu_torch serve answers as the in-process server and exits 0 on SIGINT",
                    same and rc == 0, f"({st}, exit {rc})")
        numbers["cli_up_s"] = up_s
    finally:
        srv.shutdown()
    total = {name: sum(c[name] for c in launches.values()) for name in next(iter(launches.values()))}
    print(f"serve phase launches: {launches}; in all {total}")
    for name in KERNELS:
        checks.true(f"serve phase: {name} launched", total[name] >= 1, f"({total[name]})")
    return {"launches": launches, "total": total, "numbers": numbers}


def bits_apart_t(got: dict, want: dict) -> dict:
    """`bits_apart` for tensor dicts (moved to the host)."""
    return bits_apart({k: v.cpu().numpy() for k, v in got.items()}, {k: v.cpu().numpy() for k, v in want.items()})


def hold_sharded(name: str, got: dict, want: dict, sample_rate: float, checks: Checks) -> dict:
    """Phase 12's rule for a sharded output against its unsharded twin on
    the card: formant freqs and bandwidths bit for bit (kernel D sees the
    same resonances: A, B, C and P are row-invariant, phase 3); f0 and
    f0_strength at the slice test's tolerance (rtol 1e-5, 5e-3 on the
    knife edge); RMS at rtol 1e-6, a few float32 ulps (PyTorch's row
    reduction splits a row another way at another row count: 4,201 of the
    CLI path's 35,689 frames part by up to 3e-8); MFCC within BUDGETS
    (cuBLAS picks its GEMM by the product's rows, phase 11); status and
    hnr_db's finite frames equal. Returns and prints the values not
    bit-equal, by key."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    apart = bits_apart_t(got, want)
    print(f"  {name}: values not bit-equal by key {apart} of {sum(v.numel() for v in want.values())}")
    for key in ("formant_freqs", "formant_bws"):
        checks.true(f"{name} {key} bit for bit", apart[key] == 0, f"({apart[key]} apart)")
    for key in ("f0", "f0_strength"):
        rt = knife_rtol(want["f0"], sample_rate, 1e-5)
        err = (got[key] - want[key]).abs()
        nbad = int((err > 1e-8 + rt * want[key].abs()).sum())
        checks.true(f"{name} {key}", nbad == 0, f"max_abs_err {float(err.max()):.3e}, {nbad} outside")
    checks.close(f"{name} rms", got["rms"], want["rms"], 1e-6, 0.0)
    checks.close(f"{name} mfcc", got["mfcc"], want["mfcc"], 0.0, BUDGETS["mfcc"])
    checks.equal(f"{name} status", got["status"], want["status"])
    checks.equal(f"{name} hnr_db finite", torch.isfinite(got["hnr_db"]), torch.isfinite(want["hnr_db"]))
    return apart


def check_sharded(sig32, recs: list, lengths: list, card: str, checks: Checks, run_counted, dev) -> dict:
    """Phase 12: `voxtpu_torch.dist` and its entry points on the one card,
    every mesh listing it several times (see the module docstring).
    Returns the launches of each counted run and the phase's numbers."""
    import torch

    from voxtpu_torch import cli, dist, serve
    from voxtpu_torch.formants import formant_tracker_batched
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.pipeline import (
        BENCH_44K, CLI_DEFAULT_44K, _local_peak, _path_outputs, analyze, analyze_batch_padded, analyze_frames,
    )

    cfg, vcfg = CLI_DEFAULT_44K, with_viterbi(CLI_DEFAULT_44K)
    sr = cfg.sample_rate
    launches, numbers = {}, {}
    mesh = dist.make_mesh(1, 4, [dev] * 4)
    frames = frame_signal(sig32, cfg.frame_len, cfg.hop)
    F = frames.shape[0]
    print(f"sharded: {mesh}, CLI path float32, {F} frames (4 shards of {-(-F // 4)}, the last padded)")

    # Exact mode at full width, against the card's own `analyze`.
    analyze(sig32[: 50 * cfg.hop + cfg.frame_len], cfg)
    want, launches["analyze"] = run_counted("analyze, CLI path float32", lambda: analyze(sig32, cfg))
    got, launches["exact"] = run_counted("sharded_analyze 1x4 exact, CLI path float32",
                                         lambda: dist.sharded_analyze(frames[None], cfg, mesh))
    got = {k: v[0] for k, v in got.items()}
    checks.true("sharded 1x4: keys and shapes equal analyze's", got.keys() == want.keys()
                and all(got[k].shape == want[k].shape for k in want))
    for name in ("pitch_pre", "refine", "burg", "find_roots", "polish"):
        checks.true(f"sharded 1x4: {name} launched once a block", launches["exact"][name] == 4,
                    f"({launches['exact'][name]})")
    checks.true("sharded 1x4: formant_scan once for the files row, ct_fused and viterbi not at all",
                launches["exact"]["formant_scan"] == 1 and launches["exact"]["ct_fused"] == 0
                and launches["exact"]["viterbi"] == 0, f"{launches['exact']}")
    numbers["exact_bits_apart"] = hold_sharded("sharded 1x4 exact vs analyze", got, want, sr, checks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist.sharded_analyze(frames[None], cfg, mesh)
        synced = ""
    except RuntimeError as e:
        synced = str(e)[-1500:]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    checks.true("sharded 1x4 exact ran with no host sync (set_sync_debug_mode('error'))", not synced, synced)
    numbers["exact_ms"] = sync_ms(lambda: dist.sharded_analyze(frames[None], cfg, mesh))
    numbers["analyze_ms"] = sync_ms(lambda: analyze(sig32, cfg))
    print(f"sharded_analyze 1x4 exact: {numbers['exact_ms']:.2f} ms, launches {launches['exact']}; analyze of the "
          f"same recording: {numbers['analyze_ms']:.2f} ms, launches {launches['analyze']} (one card listed four "
          f"times: the blocks run in turn) [{card}]")

    # Viterbi on: kernel F once over the gathered candidates.
    vwant = analyze(sig32, vcfg)
    vgot, launches["viterbi"] = run_counted("sharded_analyze 1x4 exact with --viterbi, CLI path float32",
                                            lambda: dist.sharded_analyze(frames[None], vcfg, mesh))
    vgot = {k: v[0] for k, v in vgot.items()}
    checks.true("sharded 1x4 viterbi: viterbi and formant_scan once for the files row",
                launches["viterbi"]["viterbi"] == 1 and launches["viterbi"]["formant_scan"] == 1,
                f"{launches['viterbi']}")
    numbers["viterbi_bits_apart"] = hold_sharded("sharded 1x4 viterbi vs analyze", vgot, vwant, sr, checks)
    path = {k: v.cpu() for k, v in _path_outputs(vgot, vcfg, _local_peak(frames)).items()}
    papart = bits_apart_t({k: vgot[k] for k in path}, path)
    checks.true("sharded 1x4 viterbi: f0, f0_strength, hnr_db bit for bit with pitch_path over its gathered "
                "candidates", not any(papart.values()), f"{papart}")
    numbers["viterbi_ms"] = sync_ms(lambda: dist.sharded_analyze(frames[None], vcfg, mesh))
    print(f"sharded_analyze 1x4 exact with --viterbi: {numbers['viterbi_ms']:.2f} ms, launches "
          f"{launches['viterbi']} [{card}]")

    # Halo mode, against the composition on the card: the padded recording's
    # resonances, each shard's [zeros or left tail | own] through kernel D.
    hgot, launches["halo"] = run_counted("sharded_analyze 1x4 halo (overlap 8), CLI path float32",
                                         lambda: dist.sharded_analyze(frames[None], cfg, mesh, overlap=8, exact=False))
    Fp, Fl, ov = -(-F // 4) * 4, -(-F // 4), 8
    res = analyze_frames(torch.nn.functional.pad(frames, (0, 0, 0, Fp - F)), cfg, return_formant_candidates=True)
    rf, rb = res["resonance_freqs"][None], res["resonance_bws"][None]
    ef = torch.as_tensor(cfg.formant.estimates, dtype=torch.float32, device=dev)
    eb = torch.full_like(ef, cfg.formant.estimate_bandwidth)
    hf, hb = [], []
    for j in range(4):
        lo = j * Fl - ov
        pf = rf[:, lo : j * Fl] if j else torch.zeros_like(rf[:, :ov])
        pb = rb[:, lo : j * Fl] if j else torch.zeros_like(rb[:, :ov])
        tf, tb = formant_tracker_batched(torch.cat([pf, rf[:, j * Fl : (j + 1) * Fl]], 1),
                                         torch.cat([pb, rb[:, j * Fl : (j + 1) * Fl]], 1), ef, eb)
        hf.append(tf[:, ov:])
        hb.append(tb[:, ov:])
    comp = {"formant_freqs": torch.cat(hf, 1)[0, :F], "formant_bws": torch.cat(hb, 1)[0, :F]}
    hapart = bits_apart_t({k: hgot[k][0] for k in comp}, comp)
    checks.true("sharded 1x4 halo: formants bit for bit with the composition on the card", not any(hapart.values()),
                f"{hapart}")
    checks.true("sharded 1x4 halo: formant_scan once a shard", launches["halo"]["formant_scan"] == 4,
                f"({launches['halo']['formant_scan']})")
    moved = int((hgot["formant_freqs"][0] != got["formant_freqs"]).any(-1).sum())
    numbers["halo_frames_off_exact"] = moved
    print(f"  halo mode: {moved} of {F} frames' formants differ from the exact carry (the shards' first frames)")

    # The corpus block loop at BENCH_44K over the 16 recordings, 2x2 listed
    # mesh, each file against its row of `analyze_batch_padded`.
    bcfg = BENCH_44K
    mesh22 = dist.make_mesh(2, 2, [dev] * 4)
    rec32 = [torch.as_tensor(r, dtype=torch.float32, device=dev) for r in recs]
    files_out = {}

    def corpus():
        cli.corpus_sharded(mesh22, list(range(len(recs))), bcfg,
                           lambda b: frame_signal(rec32[b], bcfg.frame_len, bcfg.hop),
                           save=files_out.__setitem__, read_error=lambda b, e: None)
        return files_out

    _, launches["corpus"] = run_counted("cli.corpus_sharded, 2x2 mesh, 16 recordings at BENCH_44K float32", corpus)
    nblocks = -(-len(recs) // 2)
    for name in ("pitch_pre", "refine", "burg", "find_roots", "polish", "ct_fused"):
        checks.true(f"corpus_sharded 2x2: {name} once a grid block", launches["corpus"][name] == 4 * nblocks,
                    f"({launches['corpus'][name]})")
    checks.true("corpus_sharded 2x2: formant_scan once a files row", launches["corpus"]["formant_scan"] == 2 * nblocks,
                f"({launches['corpus']['formant_scan']})")
    block32 = torch.zeros((len(recs), max(lengths)), dtype=torch.float32, device=dev)
    for b, r in enumerate(rec32):
        block32[b, : len(r)] = r
    ref = analyze_batch_padded(block32, lengths, bcfg)
    capart = {}
    for b in range(len(recs)):
        nf = (lengths[b] - bcfg.frame_len) // bcfg.hop + 1
        row = {k: v[b, :nf] for k, v in ref.items()}
        got_b = {k: torch.as_tensor(v) for k, v in files_out[b].items()}
        for k, n in hold_sharded(f"corpus_sharded file {b} vs its block row", got_b, row, sr, checks).items():
            capart[k] = capart.get(k, 0) + n
    numbers["corpus_bits_apart"] = capart
    numbers["corpus_ms"] = sync_ms(corpus, runs=3)
    print(f"corpus_sharded 2x2, 16 recordings ({sum(lengths) / sr:.1f} s): {numbers['corpus_ms']:.2f} ms with the "
          f"copies to the host, launches {launches['corpus']} [{card}]")

    # The serve split over the card listed twice against one dispatch.
    scfg = cli.build_analysis_config(sr)
    Fp_s = 1024
    S = serve._samples_for_frames(scfg, Fp_s)
    # Four recordings on the 1024 rung, 7.3-10.3 s, each cut to its framed samples.
    srecs = []
    for b in range(4):
        nf = (min(len(recs[b]), S - b * int(sr)) - scfg.frame_len) // scfg.hop + 1
        srecs.append(recs[b][: (nf - 1) * scfg.hop + scfg.frame_len].astype(np.float32))
    stack = torch.zeros((4, S), dtype=torch.float32).pin_memory()
    slen = torch.zeros((4,), dtype=torch.int64).pin_memory()
    for i, r in enumerate(srecs):
        stack[i, : len(r)] = torch.as_tensor(r)
        slen[i] = len(r)
    split = {}
    for n in (1, 2):
        (out, manifest, timers), launches[f"serve_split_{n}"] = run_counted(
            f"serve.dispatch_split over {n} block(s) of 4 recordings", lambda: serve.dispatch_split(
                stack, slen, scfg, [dev] * n, Fp_s))
        split[n] = (serve._unpack_frames(out.numpy(), manifest), sum(t.seconds() for t in timers))
    sapart = bits_apart(split[2][0], split[1][0])
    checks.true("serve split over [cuda:0] * 2: bit for bit with one dispatch", not any(sapart.values()), f"{sapart}")
    # The server takes its cards from `local_devices`; list the one card twice.
    local_devices = serve.local_devices
    serve.local_devices = lambda device: [dev] * 2
    try:
        srv = serve.VoxServer(serve.ServeConfig(port=0, max_batch=4, data_parallel=2, device=str(dev)))
    finally:
        serve.local_devices = local_devices
    srv.start()  # shutdown() stops a started server
    try:
        items = [serve._Pending(r, (len(r) - scfg.frame_len) // scfg.hop + 1) for r in srecs[:3]]
        key = (srv._config(sr, dict(srv.cfg.defaults)), Fp_s, scfg.frame_len)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = srv.batcher._dispatch(key, items)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        errors = [it.error for it in items if it.error]
        checks.true("serve data_parallel 2: one dispatch split over two blocks with no host sync",
                    pending is not None and not errors and len(pending[5]) == 2, errors[0][-1500:] if errors else "")
        if pending is not None:
            srv.batcher._drain(pending)
            dapart = {}
            for i, it in enumerate(items):
                for k, n in bits_apart(it.result, {k: v[i, : it.F] for k, v in split[1][0].items()}).items():
                    dapart[k] = dapart.get(k, 0) + n
            checks.true("serve data_parallel 2: each answer bit for bit with one dispatch", not any(dapart.values()),
                        f"{dapart}")
    finally:
        srv.shutdown()
    numbers["serve_split_device_s"] = {n: split[n][1] for n in split}
    print(f"serve dispatch_split of 4 recordings at (B, Fp) = (4, {Fp_s}): device time {1e3 * split[1][1]:.2f} ms in one "
          f"block, {1e3 * split[2][1]:.2f} ms summed over two blocks on the one card [{card}]")

    # The dryruns: the topology matrix on the card listed 4 times, then two
    # ranks sharing the card over gloo (NCCL takes one rank a card).
    _, launches["dryrun"] = run_counted("dist.dryrun_multichip(4) on [cuda:0] * 4",
                                        lambda: dist.dryrun_multichip(4, devices=[dev] * 4))
    t0 = time.perf_counter()
    dist.launch_multiprocess_dryrun(n_devices=2, n_processes=2, timeout=300, device=str(dev), backend="gloo")
    numbers["multiprocess_s"] = time.perf_counter() - t0
    print(f"multiprocess dryrun (2 ranks over gloo on one card): {numbers['multiprocess_s']:.1f} s, process starts "
          f"included [{card}]")
    total = {name: sum(c[name] for k, c in launches.items() if k != "analyze") for name in KERNELS}
    print(f"sharded phase launches: {launches}; in all (analyze's reference run aside) {total}")
    for name in KERNELS:
        checks.true(f"sharded phase: {name} launched", total[name] >= 1, f"({total[name]})")
    return {"launches": launches, "total": total, "numbers": numbers}


def x3_bound(x, nfft: int) -> tuple[float, str]:
    """Kernel X3's bound at (F, n) frames x: its products on the tensor
    cores, three bfloat16 passes each, at the dense bfloat16 rate (stage 1,
    two (N1 x rows) @ (rows x 128); stage 3, four (N1 x 128) @ (128 x 128);
    the inverse, two (N1 x 128) @ (128 x 128) and two (rows x N1) @
    (N1 x 128); rows = n / 128, N1 = nfft / 128); it reads x once and writes
    (F, n/2 + 1) + (F, n) float32 values. The elementwise twiddles, powers
    and the split (about 0.3% of the operations) are left out."""
    F, n = x.shape
    N1, rows = nfft // 128, n // 128
    macs = 2 * N1 * rows * 128 + 4 * N1 * 128 * 128 + 2 * N1 * 128 * 128 + 2 * rows * N1 * 128
    return bound(4 * (F * n + F * (n // 2 + 1) + F * n), F * 3 * 2 * macs / BF16_TC_OPS_S)


def ct_chain(x, nfft: int):
    """The "ct" backend's chain (ops/ct_fft.py, cuBLAS products): the half
    power and the lags of (F, n) frames."""
    from voxtpu_torch.ops import ct_fft

    p = ct_fft.ct_power(x, nfft)
    return ct_fft.ct_half_power(p, x.shape[-1] // 2 + 1), ct_fft.ct_autocorr(p, x.shape[-1])


def f64_transform(x, nfft: int):
    """The float64 FFT's (half, lags) of x on the card: the reference the
    matmul backends are held to."""
    import torch

    spec = torch.fft.rfft(x.double(), n=nfft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return power[:, ::2], torch.fft.irfft(power, n=nfft, dim=-1)[:, : x.shape[-1]]


def close_per_frame(name: str, got, want, tol: float, checks: Checks) -> float:
    """got within tol of want, per frame, relative to the frame's largest
    |want|; returns the largest such error."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    checks.close(name, got.double() / scale, want.double() / scale, 0.0, tol)
    return float(((got.double() - want.double()) / scale).abs().max())


def check_bench(card: str, checks: Checks, run_counted, expect_launches, dev) -> dict:
    """Phase 13: `voxtpu_torch.bench` in process at full size, each of its
    runs' launches, its host syncs; then `python -m voxtpu_torch bench` as
    a new process, its one JSON line."""
    import torch

    from voxtpu_torch import bench
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.pipeline import BENCH_44K

    samples = np.asarray(read_wav(str(bench.FIXTURE)).samples, np.float32)
    frames = frame_signal(torch.as_tensor(np.tile(samples, bench.TILES), device=dev), BENCH_44K.frame_len,
                          BENCH_44K.hop)
    bench._checksum(frames)
    _, one = run_counted("bench: one checksummed run", lambda: bench._checksum(frames))
    expect_launches("in one bench run", one, viterbi=0)
    del frames
    res, counts = run_counted("bench: voxtpu_torch.bench.run()", lambda: bench.run(dev))
    runs = 2 + bench.ITERS + bench.CHAIN * (bench.ITERS + 1)  # warm, syncs, wall; chained warm and timed
    expect_launches(f"in bench.run() ({runs} runs)", counts, viterbi=0, **{
        name: runs for name in ("ct_fused", "pitch_pre", "refine", "burg", "find_roots", "formant_scan", "polish")})
    checks.true("bench.run(): bench.py's keys, finite and positive", all(
        k in res for k in bench.KEYS) and all(math.isfinite(res[k]) and res[k] > 0 for k in bench.KEYS[4:]),
        str({k: res[k] for k in bench.KEYS}))
    print(f"bench in process: {json.dumps({k: res[k] for k in bench.KEYS})}; {res['frames']} frames, "
          f"{res['audio_seconds']:.3f} audio-s, {res['host_syncs']} host sync(s) in one run before its fetch "
          f"(at {res['host_sync_sites']}) [{card}]")
    cmd = [sys.executable, "-m", "voxtpu_torch", "bench", *([] if dev.type == "cuda" else ["--device", str(dev)])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    print(f"{' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s (process start, CUDA init, kernel load and "
          f"the runs); stdout lines {len(lines)}; stderr: {proc.stderr.strip()[-800:]}")
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    checks.true("python -m voxtpu_torch bench: exit 0, one JSON line with bench.py's keys",
                proc.returncode == 0 and len(lines) == 1 and tuple(line) == bench.KEYS, f"({proc.returncode})")
    return {"in_process": {k: res[k] for k in (*bench.KEYS, "frames", "audio_seconds", "host_syncs",
                                                "host_sync_sites")},
            "command": line, "command_s": wall, "launches": counts}


def check_autocorr_backends(x, nfft: int, signal, build_log: str, card: str, checks: Checks, run_counted,
                            dev) -> dict:
    """Phase 14: kernel X3, the "ct" chain and kernel E at the bench shapes
    (x: the bench path's (F, 4096) windowed float32 frames): X3 through
    `power_and_autocorrelate(backend="ct_fused_x3")`, counted; X3 against
    its plain version and all three against the float64 FFT; X3 at every n
    its gate admits; float64 into X3 raises; times, X3's bound, registers
    and spills; then X3 at n = 16,384 over `signal` (the bench path's
    float32 samples) framed 16,384 / 4,096, beside cuFFT, and kernel E at
    the same frames (a cluster of 2 blocks a frame) against its plain
    version and the float64 FFT, timed beside X3 and cuFFT. Returns X3's
    row of the kernels line and E's numbers at n = 16,384."""
    import torch

    from voxtpu_torch import autocorr
    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops import ct_fused, ct_x3

    (half, ac), counts = run_counted("power_and_autocorrelate(backend='ct_fused_x3'), bench shapes",
                                     lambda: autocorr.power_and_autocorrelate(x, quirk=False, backend="ct_fused_x3"))
    checks.true("ct_fused_x3 at the bench shapes: X3 launched once, nothing else",
                counts["ct_x3"] == 1 and sum(v for k, v in counts.items() if k != "ct_x3") == 0, str(counts))
    hp, ap = ct_x3.ct_x3_power_ac_plain(x, nfft)
    rel = max(close_per_frame("X3 half vs plain / frame max [bench]", half, hp, X3_TOL, checks),
              close_per_frame("X3 ac vs plain / frame max [bench]", ac, ap, X3_TOL, checks))
    err = max(float((half - hp).abs().max()), float((ac - ap).abs().max()))
    del hp, ap
    h64, a64 = f64_transform(x, nfft)
    errs64 = {"ct_x3": max(close_per_frame("X3 half vs float64 fft [bench]", half, h64, X3_TOL, checks),
                           close_per_frame("X3 ac vs float64 fft [bench]", ac, a64, X3_TOL, checks))}
    hc, acc = ct_chain(x, nfft)
    errs64["ct"] = max(close_per_frame("ct half vs float64 fft [bench]", hc, h64, X3_TOL, checks),
                       close_per_frame("ct ac vs float64 fft [bench]", acc, a64, X3_TOL, checks))
    he, ae = ct_fused.ct_fused_power_ac(x, nfft)
    errs64["ct_fused"] = max(close_per_frame("E half vs float64 fft [bench]", he, h64, CT_FUSED_F32_TOL, checks),
                             close_per_frame("E ac vs float64 fft [bench]", ae, a64, CT_FUSED_F32_TOL, checks))
    del h64, a64, hc, acc, he, ae, half, ac
    gen = torch.Generator(device=dev).manual_seed(0)

    def worst_vs_plain(frames: int, ns) -> float:
        """X3's largest distance from its plain version over random frames
        of each n, relative to each frame's largest value."""
        worst = 0.0
        for n in ns:
            xs = torch.randn((frames, n), generator=gen, device=dev)
            hk, ak = ct_x3.ct_x3_power_ac(xs, 2 * n)
            hp, ap = ct_x3.ct_x3_power_ac_plain(xs, 2 * n)
            for k, p in ((hk, hp), (ak, ap)):
                scale = p.abs().amax(dim=-1, keepdim=True)
                worst = max(worst, float(((k - p) / scale).abs().max()))
        return worst

    admitted = [n for n in range(128, 24000, 128) if ct_x3.ct_x3_supported(n, 2 * n)]
    gate_err = worst_vs_plain(4, admitted)
    checks.true(f"X3 vs plain at every n its gate admits ({len(admitted)}: {admitted[0]} .. {admitted[-1]}, 4 frames "
                f"each), per frame within {X3_TOL}", gate_err <= X3_TOL and admitted[-1] == 20608,
                f"(largest {gate_err:.3e})")
    many = 2 * torch.cuda.get_device_properties(dev).multi_processor_count + 1
    many_err = worst_vs_plain(many, X3_MANY_NS)
    checks.true(f"X3 vs plain with {many} frames (each block walks two or three) at n = {X3_MANY_NS}, per frame "
                f"within {X3_TOL}", many_err <= X3_TOL, f"(largest {many_err:.3e})")
    raised = []
    for fn in (lambda: ct_x3.ct_x3_power_ac(x[:2].double(), nfft),
               lambda: autocorr.power_and_autocorrelate(x[:2].double(), backend="ct_fused_x3")):
        try:
            fn()
        except ValueError as e:
            raised.append("float32 only" in str(e))
    checks.true("float64 into X3 on the card raises ValueError", raised == [True, True], str(raised))
    ms = {"ct_x3": event_ms(lambda: ct_x3.ct_x3_power_ac(x, nfft)),
          "ct_fused": event_ms(lambda: ct_fused.ct_fused_power_ac(x, nfft)),
          "ct": event_ms(lambda: ct_chain(x, nfft)),
          "cufft": event_ms(lambda: cufft_power_ac(x, nfft)),
          "plain": event_ms(lambda: ct_x3.ct_x3_power_ac_plain(x, nfft), runs=3)}
    bound_ms, bound_by = x3_bound(x, nfft)
    regs = kernel_registers(build_log, "ct_x3_kernel")
    spills = stack_frames(build_log, "ct_x3_kernel")
    checks.true("X3's kernel: 0 bytes stack frame and spill", len(spills) == STACK_CHECKED["ct_x3_kernel"]
                and all(v == (0, 0, 0) for v in spills.values()), str(sorted(spills.values())))
    print(f"  ct_x3, bench shapes ({x.shape[0]} frames of {x.shape[1]}): kernel {ms['ct_x3']:.3f} ms, plain "
          f"{ms['plain']:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}; E {ms['ct_fused']:.3f} ms, the ct chain "
          f"(cuBLAS) {ms['ct']:.3f} ms, cuFFT rfft-power-irfft {ms['cufft']:.3f} ms; registers "
          f"{sorted(regs.values())}, stack/spill {sorted(spills.values())}; vs float64 fft {errs64} [{card}]")
    # n = 16,384: X3 beside E, whose float32 frames of 16,384 take a cluster
    # of 2 blocks, and cuFFT.
    n16 = 16384
    x16 = hann_windowed(frame_signal(signal, n16, n16 // 4))
    h16, a16 = ct_x3.ct_x3_power_ac(x16, 2 * n16)
    hp, ap = ct_x3.ct_x3_power_ac_plain(x16, 2 * n16)
    err16 = max(close_per_frame(f"X3 half vs plain / frame max [n = {n16}]", h16, hp, X3_TOL, checks),
                close_per_frame(f"X3 ac vs plain / frame max [n = {n16}]", a16, ap, X3_TOL, checks))
    del hp, ap
    h64, a64 = f64_transform(x16, 2 * n16)
    err16_64 = max(close_per_frame(f"X3 half vs float64 fft [n = {n16}]", h16, h64, X3_TOL, checks),
                   close_per_frame(f"X3 ac vs float64 fft [n = {n16}]", a16, a64, X3_TOL, checks))
    e16_abs = check_ct_fused(x16, 2 * n16, checks, f"{x16.shape[0]} frames of {n16}, recording, f32")
    he, ae = ct_fused.ct_fused_power_ac(x16, 2 * n16)
    e16_64 = max(close_per_frame(f"E half vs float64 fft [n = {n16}]", he, h64, CT_FUSED_F32_TOL, checks),
                 close_per_frame(f"E ac vs float64 fft [n = {n16}]", ae, a64, CT_FUSED_F32_TOL, checks))
    del h16, a16, h64, a64, he, ae
    ms16 = {"ct_x3": event_ms(lambda: ct_x3.ct_x3_power_ac(x16, 2 * n16)),
            "cufft": event_ms(lambda: cufft_power_ac(x16, 2 * n16)),
            "ct_fused": event_ms(lambda: ct_fused.ct_fused_power_ac(x16, 2 * n16)),
            "ct_fused_plain": event_ms(lambda: ct_fused.ct_fused_power_ac_plain(x16, 2 * n16))}
    bound16 = x3_bound(x16, 2 * n16)
    e_bound16 = ct_fused_bound(x16, 2 * n16)
    print(f"  ct_x3, {x16.shape[0]} frames of {n16}: kernel {ms16['ct_x3']:.3f} ms, cuFFT rfft-power-irfft "
          f"{ms16['cufft']:.3f} ms, bound {bound16[0]:.4f} ms by {bound16[1]}; within {err16:.3e} of plain and "
          f"{err16_64:.3e} of the float64 fft per frame [{card}]")
    print(f"  ct_fused, {x16.shape[0]} frames of {n16} (a cluster of 2 blocks a frame): kernel "
          f"{ms16['ct_fused']:.3f} ms, plain {ms16['ct_fused_plain']:.3f} ms, cuFFT {ms16['cufft']:.3f} ms, X3 "
          f"{ms16['ct_x3']:.3f} ms, bound {e_bound16[0]:.4f} ms by {e_bound16[1]}; within {e16_64:.3e} of the "
          f"float64 fft per frame [{card}]")
    e16 = {"ms": ms16["ct_fused"], "plain_ms": ms16["ct_fused_plain"], "bound_ms": e_bound16[0],
           "bound_by": e_bound16[1], "library_ms": ms16["cufft"], "x3_ms": ms16["ct_x3"], "max_abs_err": e16_abs,
           "err_vs_f64_fft": e16_64, "frames": x16.shape[0], "n": n16, "dtype": "float32"}
    x3_row = {
        "name": "ct_x3", "route": "cuda", "source": X3[0], "replaces": X3[1], "launches": counts["ct_x3"],
        "max_abs_err": err, "max_rel_err_per_frame": rel, "ms": ms["ct_x3"], "plain_ms": ms["plain"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": ms["ct"], "path": "autocorr_x3", "frames": x.shape[0], "cufft_ms": ms["cufft"],
        "ct_fused_ms": ms["ct_fused"], "err_vs_f64_fft": errs64, "gate_ns": len(admitted), "gate_err": gate_err,
        "many_frames": {"frames": many, "ns": X3_MANY_NS, "err": many_err},
        "registers": regs, "stack_spill": spills, "launches_by_path": {"autocorr_x3": counts["ct_x3"]},
        "n16384": {"frames": x16.shape[0], "ms": ms16["ct_x3"], "cufft_ms": ms16["cufft"], "bound_ms": bound16[0],
                   "err_vs_plain": err16, "err_vs_f64_fft": err16_64, "ct_fused_ms": ms16["ct_fused"]},
    }
    return x3_row, e16


def check_ct_fused_pfa(signal, build_log: str, card: str, checks: Checks) -> dict:
    """Phase 14's rows of kernel E at lengths that are not powers of two
    (E_PFA_NS): the recording `signal` framed n / (n / 4) and windowed, in
    float32 and in float64; E against its plain version (CT_FUSED_F32_TOL
    per frame, the float64 tolerances) and, in float32, against the float64
    FFT per frame; the times (CUDA events, mean of 5) of E, its plain
    version, cuFFT's rfft-power-irfft and, in float32, X3 on the same
    frames; E's bound, the function's work (`ct_fused_bound`), and beside
    it the least time for its tensor-core products (`ct_fused_pfa_algo_ms`);
    the prime-factor kernel's registers and stack/spill. Then the float64
    layout with the buffer in device memory on 2 x SMs + 1 seeded noise
    frames at E_DEVICE_MANY_NS (the wrapper runs one block an SM, so each
    block walks two or three frames through its scratch slice), against
    the plain version at the float64 tolerances. Returns {f"n{n}_f32":
    numbers, f"n{n}_f64": numbers, "device_many_f64": numbers}."""
    import torch

    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops import ct_fused, ct_x3

    regs = kernel_registers(build_log, "ct_fused_pfa_kernel")
    spills = stack_frames(build_log, "ct_fused_pfa_kernel")
    print(f"  ct_fused_pfa_kernel: registers {sorted(regs.values())}, stack/spill {sorted(set(spills.values()))} "
          f"over {len(spills)} instantiations")
    checks.true("ct_fused_pfa_kernel: 0 bytes of stack frame and spill",
                bool(spills) and all(v == (0, 0, 0) for v in spills.values()), sorted(set(spills.values())))
    out = {}
    for n in E_PFA_NS:
        x32 = hann_windowed(frame_signal(signal, n, n // 4))
        n1 = n & -n
        for x in (x32, x32.double()):
            dname = "f32" if x.dtype == torch.float32 else "f64"
            err = check_ct_fused(x, 2 * n, checks, f"{x.shape[0]} frames of {n}, recording, {dname}")
            v = {"ms": event_ms(lambda: ct_fused.ct_fused_power_ac(x, 2 * n)),
                 "plain_ms": event_ms(lambda: ct_fused.ct_fused_power_ac_plain(x, 2 * n)),
                 "library_ms": event_ms(lambda: cufft_power_ac(x, 2 * n))}
            text = f"kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, cuFFT {v['library_ms']:.3f} ms"
            if dname == "f32":
                he, ae = ct_fused.ct_fused_power_ac(x, 2 * n)
                h64, a64 = f64_transform(x, 2 * n)
                v["err_vs_f64_fft"] = max(
                    close_per_frame(f"E half vs float64 fft [n = {n}]", he, h64, CT_FUSED_F32_TOL, checks),
                    close_per_frame(f"E ac vs float64 fft [n = {n}]", ae, a64, CT_FUSED_F32_TOL, checks))
                del he, ae, h64, a64
                v["x3_ms"] = event_ms(lambda: ct_x3.ct_x3_power_ac(x, 2 * n))
                text += f", X3 {v['x3_ms']:.3f} ms"
            bound_ms, bound_by = ct_fused_bound(x, 2 * n)
            v.update(bound_ms=bound_ms, bound_by=bound_by, algo_bound_ms=ct_fused_pfa_algo_ms(x, 2 * n),
                     max_abs_err=err, frames=x.shape[0], n=n, n1=n1, m=n // n1, dtype=dname,
                     layout=ct_fused.ct_fused_layout(n, x.dtype), staged=ct_fused.ct_fused_pfa_staged(n, x.dtype))
            out[f"n{n}_{dname}"] = v
            tail = f"; within {v['err_vs_f64_fft']:.3e} of the float64 fft per frame" if dname == "f32" else ""
            print(f"  ct_fused, {v['frames']} frames of {n} = {n1} x {v['m']}, {dname}, {v['layout']}"
                  f"{', staged' if v['staged'] else ''} (prime-factor kernel): {text}, bound {bound_ms:.4f} ms by "
                  f"{bound_by} (its tensor-core products alone: {v['algo_bound_ms']:.4f} ms){tail} [{card}]")
        del x32, x
    dev = signal.device
    many = 2 * torch.cuda.get_device_properties(dev).multi_processor_count + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = []
    for n in E_DEVICE_MANY_NS:
        layout = ct_fused.ct_fused_layout(n, torch.float64)
        checks.true(f"ct_fused at n = {n} float64 keeps its buffer in device memory", layout == "device", layout)
        x = torch.randn((many, n), generator=gen, dtype=torch.float64, device=dev)
        errs.append(check_ct_fused(x, 2 * n, checks, f"{many} frames of {n} (each block walks two or three), "
                                                     f"{layout}, f64"))
    out["device_many_f64"] = {"frames": many, "ns": E_DEVICE_MANY_NS, "max_abs_err": max(errs)}
    print(f"  ct_fused, float64, buffer in device memory: {many} frames at n = {E_DEVICE_MANY_NS} within "
          f"{max(errs):.3e} of the plain version")
    return out


def check_many_estimates(checks: Checks, dev) -> None:
    """`analyze` at CLI_DEFAULT_44K with MANY_ESTIMATES starting estimates
    (`extended_estimates`) in float64 on the card, counted (kernel D once,
    every frame's status 0, F x MANY_ESTIMATES formants), against the plain
    CPU path over the first 2 s of the recording at the slice tolerances
    (`compare_slice`)."""
    import torch

    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import formant_scan
    from voxtpu_torch.pipeline import CLI_DEFAULT_44K, analyze

    base = CLI_DEFAULT_44K
    cfg = dataclasses.replace(base, formant=dataclasses.replace(base.formant,
                                                                 estimates=extended_estimates(MANY_ESTIMATES)))
    head = np.tile(np.asarray(read_wav(str(FIXTURE)).samples, dtype=np.float64), 2)[: int(2 * cfg.sample_rate)]
    formant_scan.formant_scan.launches = 0
    card = analyze(torch.as_tensor(head, device=dev), cfg)
    torch.cuda.synchronize()
    launched = formant_scan.formant_scan.launches
    shape = tuple(card["formant_freqs"].shape)
    nonzero = int(card["status"].count_nonzero())
    checks.true(f"{MANY_ESTIMATES} estimates, float64 on the card: formant_scan launched once, status 0",
                launched == 1 and nonzero == 0 and shape[1:] == (MANY_ESTIMATES,),
                f"({launched} launch(es), {nonzero} nonzero statuses, formants {shape})")
    cpu = analyze(torch.as_tensor(head), cfg)
    compare_slice(f"{MANY_ESTIMATES} estimates f64 card vs cpu", card, cpu, cfg.sample_rate, checks)


def side_checks() -> None:
    """`python3 chip_smoke.py --side`, which `main` starts once it has built
    the kernels, and which runs beside main's phases on the same card: phase
    3d (`check_orders`; the plain roots' Python loops at N = 64 and 128 keep
    a host core busy for minutes) and `check_many_estimates` (its plain CPU
    path about a minute). Prints its checks and the seconds each took;
    raises when a check failed."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    from voxtpu_torch.ops import kernels

    kernels.library()  # main built it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # the other half of the host: main's
    dev = torch.device("cuda", 0)
    checks = Checks()
    t0 = time.perf_counter()
    print(f"kernels B, C and P vs plain at N = {', '.join(map(str, ORDER_NS))} (LPC orders to 127):")
    check_orders(checks, dev)
    t1 = time.perf_counter()
    print(f"[phase 3d, kernels B, C and P at high orders: {t1 - t0:.1f} s]")
    print(f"analyze with {MANY_ESTIMATES} estimates, float64 on the card vs the plain CPU path, first 2 s:")
    check_many_estimates(checks, dev)
    print(f"[phase 3e, {MANY_ESTIMATES} estimates: {time.perf_counter() - t1:.1f} s]", flush=True)
    checks.raise_failures()


def kernel_e_alone(root: Path) -> None:
    """`python3 chip_smoke.py --kernel-e [DIR]`: kernel E alone, imported
    from the checkout at DIR (default this one; another one, for instance
    the parent commit unpacked with `git archive` into a git-ignored
    directory, lets two versions be timed on one card in one call, run in
    turns). Builds that checkout's kernels, then runs phase 8's walk of E's
    gate (`check_ct_fused_gate`) and phase 14's prime-factor rows
    (`check_ct_fused_pfa`) with this script's checks, bounds and timing.
    Prints the card, the rows and, last, one JSON object of phase 14's
    numbers; raises when a check failed."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    root = root.resolve()
    sys.path.insert(0, str(root))
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import ct_fused, kernels

    if Path(ct_fused.__file__).resolve().parents[2] != root:
        raise SystemExit(f"voxtpu_torch imported from {ct_fused.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; kernel E from {root}", flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"[kernels built in {time.perf_counter() - t0:.1f} s]", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    checks = Checks()
    t0 = time.perf_counter()
    check_ct_fused_gate(checks, dev)
    print(f"[kernel E's gate: {time.perf_counter() - t0:.1f} s]", flush=True)
    one = np.asarray(read_wav(str(FIXTURE)).samples, dtype=np.float64)
    sig32 = torch.as_tensor(np.tile(one, TILES), device=dev).float()
    t0 = time.perf_counter()
    out = check_ct_fused_pfa(sig32, kernels.library_path().with_suffix(".log").read_text(), card, checks)
    print(f"[kernel E's prime-factor rows: {time.perf_counter() - t0:.1f} s]", flush=True)
    checks.raise_failures()
    print(json.dumps({"root": str(root), "card": card, **out}))


def check_examples(checks: Checks, run_counted, device: str = "cuda") -> dict:
    """Phase 15: examples/torch/* on the card (`--device cuda`), checked as
    tests/test_torch_examples.py checks them on the CPU."""
    import importlib.util
    import io

    outs, launches = {}, {}
    for name in ("pitch_detection", "formant_extraction", "serving_client"):
        spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, launches[name] = run_counted(f"examples/torch/{name}.py --device {device}",
                                             lambda: mod.main(["--device", device]))
        outs[name] = buf.getvalue()
        print(f"examples/torch/{name}.py: {time.perf_counter() - t0:.1f} s, {len(outs[name].splitlines())} lines; "
              f"first: {outs[name].splitlines()[:1]}")
        checks.true(f"examples/torch/{name}.py returns 0 or None", rc in (0, None), f"({rc})")
    f0 = [float(line.split("=")[1].split("Hz")[0]) for line in outs["pitch_detection"].splitlines()
          if line.startswith("frame")]
    checks.true("pitch_detection: frame 0's f0 within 0.5 Hz of 150", bool(f0) and abs(f0[0] - 150.0) < 0.5, str(f0))
    rows = [line.split() for line in outs["formant_extraction"].splitlines() if line and line[0].isdigit()]
    f1 = np.asarray([float(r[1]) for r in rows])
    voiced = f1[f1 > 0]
    checks.true("formant_extraction: over 50 rows, voiced F1 in (50, 5001) Hz", len(rows) > 50 and voiced.size > 0
                and bool(np.all((voiced > 50.0) & (voiced < 5001.0))), f"({len(rows)} rows)")
    out = outs["serving_client"]
    track = [float(v) for v in out.split("f0 track:")[1].splitlines()[0].split()] if "f0 track:" in out else []
    checks.true("serving_client: an f0 track in 60-500 Hz, stream and stats lines",
                bool([v for v in track if v > 0]) and all(60 <= v <= 500 for v in track if v > 0)
                and "server stats: " in out and "viterbi f0 track:" in out, str(track[:8]))
    return {"launches": launches, "pitch_f0": f0}


def large_config(frame_len: int):
    """LARGE_44K at frame_len: tests/test_large_frames.py:34-52's
    configuration (fmin 60, fmax 600, 16 candidates, Burg order 13, MFCC 13
    up to 8,000 Hz, hop frame_len / 4, Viterbi off) at 44.1 kHz."""
    from voxtpu_torch.pipeline import AnalysisConfig, FormantConfig, MfccConfig, PitchConfig

    return AnalysisConfig(sample_rate=44100.0, frame_len=frame_len, hop=frame_len // 4,
                          pitch=PitchConfig(fmin=60.0, fmax=600.0, max_candidates=16),
                          formant=FormantConfig(n_coeffs=13), mfcc=MfccConfig(num_coeffs=13, freq_hi=8000.0))


# Phase 16's frame lengths: 16,384 (kernel E over a cluster of 2 blocks in
# float32, 4 in float64; kernel B's register layout in float32, over a
# cluster of 2 blocks in float64) and 32,768 (past E's gate: cuFFT; B over
# a cluster of 2 blocks in float32, 4 in float64).
LARGE_NS = (16384, 32768)


# Phase 16's kernel B cases on the recording's frames (hop n / 4): (frame
# length, dtype name, the large path whose launches it reports or None).
# The path's lengths take the cluster layout; the first length past the
# cluster's reach (the device layout) is timed for the record.
LARGE_BURG = ((32768, "float32", 32768), (32768, "float64", 32768), (16384, "float64", 16384),
              (225794, "float32", None), (112898, "float64", None))


def check_large_frames(signal: np.ndarray, sig32, sig64, card: str, checks: Checks, run_counted, expect_launches,
                       cvt_s: float, build_log: str, dev) -> dict:
    """Phase 16: `analyze` at LARGE_44K over the 126 tiles at each of
    LARGE_NS in float32, counted (E launched once at 16,384 and not at
    32,768, G, A-D and P once, F never), healthy, end to end; float32
    against float64 on the card within the budgets by phase 5's rule;
    float64 on the card against the plain CPU path over the first 2 s.
    Then kernel E in float64 at 8,192 and 16,384 on the recording's frames
    (clusters of 2 and 4 blocks) and kernel B at LARGE_BURG's lengths (the
    paths' over a thread-block cluster, then the device layout past it),
    each against its plain version and timed beside its bound (E beside
    cuFFT too; B with its cluster size, registers and spill). Returns the
    phase's numbers."""
    import torch

    from voxtpu_torch.frame import frame_signal
    from voxtpu_torch.ops import burg, ct_fused
    from voxtpu_torch.pipeline import analyze

    sr = 44100.0
    head = signal[: int(2 * sr)]
    res = {"paths": {}}
    for n in LARGE_NS:
        cfg = large_config(n)
        e = 1 if n == 16384 else 0
        analyze(sig32[: 4 * n], cfg)  # warm cuFFT plans and caches
        torch.cuda.synchronize()
        out32, counts = run_counted(f"large path, n = {n}, float32", lambda: analyze(sig32, cfg))
        expect_launches(f"on the large path at n = {n}", counts, viterbi=0, ct_fused=e)
        check_health(f"large path, n = {n}", out32, checks)
        out64, counts64 = run_counted(f"large path, n = {n}, float64", lambda: analyze(sig64, cfg))
        expect_launches(f"on the large path at n = {n} in float64", counts64, viterbi=0, ct_fused=e, polish=0)
        print(f"large path, n = {n}: float32 vs float64 on the card, whole signal, against the plain path:")
        check_budgets(out32, out64, signal, cfg, checks, label=f"large n={n}")
        print(f"large path, n = {n}: float64 on the card vs the plain CPU path, first 2 s:")
        compare_slice(f"large n={n} f64 card vs cpu", analyze(torch.as_tensor(head, device=dev), cfg),
                      analyze(torch.as_tensor(head), cfg), sr, checks)
        ms = sync_ms(lambda: analyze(sig32, cfg))
        audio_s = len(signal) / sr
        res["paths"][n] = {"frames": int(out32["f0"].numel()), "e2e_ms": ms, "audio_s_per_s": audio_s / (ms / 1e3),
                           "launches": counts, "launches_f64": counts64}
        print(f"end to end, float32, large path n = {n}: {ms:.2f} ms for {audio_s:.1f} s of audio "
              f"({res['paths'][n]['frames']} frames) = {audio_s / (ms / 1e3):.1f} audio-s/s [{card}]")
        del out32, out64
    # E in float64 on the recording's frames: clusters of 2 (8,192) and 4
    # (16,384) blocks; no path runs 8,192 here, so its launches are None.
    res["ct_fused"] = {}
    for n in (8192, 16384):
        x = hann_windowed(frame_signal(sig64, n, n // 4)).contiguous()
        err = check_ct_fused(x, 2 * n, checks, f"{x.shape[0]} frames of {n}, recording, f64")
        bound_ms, bound_by = ct_fused_bound(x, 2 * n)
        v = {"ms": event_ms(lambda: ct_fused.ct_fused_power_ac(x, 2 * n)),
             "plain_ms": event_ms(lambda: ct_fused.ct_fused_power_ac_plain(x, 2 * n)),
             "library_ms": event_ms(lambda: cufft_power_ac(x, 2 * n)), "bound_ms": bound_ms, "bound_by": bound_by,
             "max_abs_err": err, "frames": x.shape[0], "n": n, "cluster": ct_fused.ct_fused_cluster(n, x.dtype),
             "launches": res["paths"][n]["launches_f64"]["ct_fused"] if n in res["paths"] else None}
        res["ct_fused"][f"n{n}_f64"] = v
        print(f"  ct_fused, {x.shape[0]} frames of {n}, float64 (a cluster of {v['cluster']} blocks a frame): kernel "
              f"{v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, cuFFT {v['library_ms']:.3f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} [{card}]")
        del x
    # B at LARGE_BURG's lengths: the paths' over a cluster, the next past it.
    res["burg"] = {}
    regs = {**kernel_registers(build_log, "burg_kernel"), **kernel_registers(build_log, "burg_cluster_kernel")}
    spills = {**stack_frames(build_log, "burg_kernel"), **stack_frames(build_log, "burg_cluster_kernel")}
    for n, dname, path in LARGE_BURG:
        dt = getattr(torch, dname)
        bx = hann_windowed(frame_signal(sig64.to(dt), n, n // 4)).contiguous()
        config = burg.launch_config(n, dt)
        want = "cluster" if path else "device"
        short = "f64" if dt == torch.float64 else "f32"
        tag = f"{bx.shape[0]} frames of {n}, {short}, {config}"
        checks.true(f"burg layout [{tag}]", config.rows == want, f"(rows in {want} wanted)")
        ck, sk = burg.burg(bx, 13)
        cp, sp = burg.burg_plain(bx, 13)
        err = checks.close(f"burg coeffs [{tag}]", ck, cp, *burg_tol(dt))
        checks.equal(f"burg status [{tag}]", sk, sp)
        del ck, sk, cp, sp
        # The instantiation's mangled name: burg_cluster_kernel<T>, or
        # burg_kernel<T, 0, kRowsDevice>.
        t = "d" if dt == torch.float64 else "f"
        inst = f"burg_cluster_kernelI{t}E" if want == "cluster" else f"burg_kernelI{t}Li0ELi{burg.ROWS[want]}E"
        bound_cvt = burg_bound(bx, 13, cvt_s)
        v = {"ms": event_ms(lambda: burg.burg(bx, 13)), "plain_ms": event_ms(lambda: burg.burg_plain(bx, 13), runs=3),
             "bound_ms": burg_bound(bx, 13)[0], "bound_cvt_ms": bound_cvt[0], "bound_by": bound_cvt[1],
             "library_ms": None, "max_abs_err": err, "frames": bx.shape[0], "n": n, "launch": config._asdict(),
             "registers": next((r for k, r in regs.items() if inst in k), None),
             "stack_spill": next((f for k, f in spills.items() if inst in k), None),
             "launches": res["paths"][path]["launches" if dt == torch.float32 else "launches_f64"]["burg"]
             if path else None}
        if want == "device":
            v["scratch_bytes"] = bx.shape[0] * 2 * config.threads * config.width * bx.element_size()
        res["burg"][f"n{n}_{short}"] = v
        print(f"  burg, {tag}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms by "
              f"operations, {v['bound_cvt_ms']:.4f} ms with the conversions (by {v['bound_by']}); {config.blocks} "
              f"block(s) a frame, {v['registers']} registers, stack/spill {v['stack_spill']} [{card}]")
        del bx
    return res


def main() -> None:
    if not (ROOT / "voxtpu_torch" / "csrc").is_dir() or not FIXTURE.is_file():
        raise SystemExit("chip_smoke.py runs from the root of a voxtpu checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, str(ROOT))
    from voxtpu_torch.frame import frame_signal, num_frames
    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.ops import (
        burg, ct_fused, ct_x3, find_roots, formant_scan, kernels, pitch_pre, polish, refine, viterbi,
    )
    from voxtpu_torch.pipeline import (
        BENCH_44K, CLI_DEFAULT_44K, FLAGSHIP_44K, analyze, analyze_batch_padded, analyze_long,
    )

    wrappers = {
        "refine": refine.refine, "burg": burg.burg, "find_roots": find_roots.find_roots,
        "formant_scan": formant_scan.formant_scan, "ct_fused": ct_fused.ct_fused_power_ac,
        "viterbi": viterbi.viterbi_path, "pitch_pre": pitch_pre.pitch_pre, "polish": polish.polish_roots,
        "ct_x3": ct_x3.ct_x3_power_ac,
    }
    checks = Checks()
    t_start = t_phase = time.perf_counter()

    def phase_took(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[{name}: {now - t_phase:.1f} s]")
        t_phase = now

    def run_counted(label: str, fn):
        """fn() with every launch count (and F's chunk count) set to 0 just
        before; returns its result and the counts just after."""
        for w in wrappers.values():
            w.launches = 0
        viterbi.viterbi_path.chunks = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        counts["viterbi_chunks"] = viterbi.viterbi_path.chunks
        print(f"{label}: launches {counts}")
        return out, counts

    def expect_launches(where: str, counts: dict, **zero_or_more) -> None:
        """Every kernel launched exactly once in a counted run (the opt-in
        X3 never), except the counts named in zero_or_more."""
        for name in wrappers:
            count, want = counts[name], zero_or_more.get(name, 0 if name in OPT_IN else 1)
            checks.true(f"{name} launched {want} time(s) {where}", count == want, f"({count})")

    # --- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    # --- 2. build
    t0 = time.perf_counter()
    nvcc = kernels.find_nvcc()  # kernels.build() says what is missing without it
    rate_cmd, rates_lib = rate_probes_build(nvcc or "nvcc")
    rate_build = subprocess.Popen(rate_cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) if nvcc else None
    try:
        lib_path = kernels.build()
    finally:
        rate_log = rate_build.communicate()[0] if rate_build else ""
    if rate_build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {RATES_SRC.relative_to(ROOT)}:\n{rate_log}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.relative_to(ROOT)}; rate probes: "
          f"{rates_lib.relative_to(ROOT)}")
    build_log = lib_path.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    for name, count in STACK_CHECKED.items():
        frames = stack_frames(build_log, name)
        checks.true(f"{name} kernels: 0 bytes stack frame and spill", len(frames) == count
                    and all(v == (0, 0, 0) for v in frames.values()), f"{sorted(frames.values())} over {len(frames)}")
    for dt in (torch.float32, torch.float64):
        for C in (33, 128):
            vc = viterbi.launch_config(1, BENCH_FRAMES, C, dt)
            print(f"viterbi_chain at C = {C}, {dt}: {vc.smem} bytes of dynamic shared memory a block ({vc.stages} "
                  f"stages of {vc.record}-byte records), {vc.chain} chain threads + 32, {vc.lanes} lanes a candidate")
    kernels.library()
    # Phase 3d and the many-estimates `analyze` run in a second process on
    # the card beside phases 3-8 (`side_checks`), joined before phase 9.
    side_log = tempfile.TemporaryFile(mode="w+")
    side = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--side"], cwd=ROOT, stdout=side_log,
                            stderr=subprocess.STDOUT, text=True)

    def stop_side() -> None:
        if side.poll() is None:
            side.kill()
            side.wait()

    atexit.register(stop_side)

    # --- data: 126 tiles of the bundled recording
    cfg = CLI_DEFAULT_44K
    sr = cfg.sample_rate
    one = np.asarray(read_wav(str(FIXTURE)).samples, dtype=np.float64)
    signal = np.tile(one, TILES)
    sig64 = torch.as_tensor(signal, device=dev)
    sig32 = sig64.float()
    frames64 = frame_signal(sig64, cfg.frame_len, cfg.hop)
    F = frames64.shape[0]
    audio_s = len(signal) / sr
    print(f"CLI path: {len(signal)} samples ({audio_s:.1f} s), {F} frames of {cfg.frame_len}, hop {cfg.hop}")
    checks.true("frame count", F == EXPECTED_FRAMES, f"{F}")

    # --- 3. kernels G, A-D and P against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path_errs, scan_runs = {}, {}  # {path: {dtype: ...}}, see check_path_kernels
    path_errs["cli"], scan_runs["cli"] = check_path_kernels(
        "CLI path", frames64, cfg, {torch.float64: None, torch.float32: None}, checks)
    del frames64
    print("kernel C vs plain on its edge rows:")
    for dt in (torch.float64, torch.float32):
        check_roots_edge(dt, dev, checks, "f64" if dt == torch.float64 else "f32")
    phase_took("phase 3, kernels vs plain")

    print("kernel D on adversarial inputs from the CLI path's float32 resonances:")
    rf32, rb32, ef32, eb32, _ = scan_runs["cli"][torch.float32]["args"]
    check_scan_stress(rf32, rb32, ef32, eb32, checks)
    print("kernel D past 16 estimates, on the CLI path's float32 resonances:")
    check_scan_estimates(rf32, rb32, checks)
    phase_took("phase 3b, kernel D on adversarial inputs and at 17, 64 and 128 estimates")

    print("kernel B's shared-memory layout vs plain, noisy frames of the recording:")
    check_burg_large(checks, dev)
    phase_took("phase 3c, kernel B on long frames")

    # (3d, B, C and P at high orders, runs in the side process.)

    # --- 4. the CLI path, float32
    analyze(sig32[: 50 * cfg.hop + cfg.frame_len], cfg)  # warm cuFFT plans and caches
    torch.cuda.synchronize()
    out32, cli_launches = run_counted("CLI path float32", lambda: analyze(sig32, cfg))
    # 2205-sample frames take cuFFT, not E, and the CLI default runs no path search (F).
    expect_launches("on the CLI path", cli_launches, ct_fused=0, viterbi=0)
    shapes = {k: tuple(v.shape) for k, v in out32.items()}
    checks.true("output shapes", shapes["f0"] == (F,) and shapes["formant_freqs"] == (F, 4)
                and shapes["mfcc"] == (F, 13) and shapes["pitch_candidates_freq"] == (F, 33), str(shapes))
    check_health("CLI path", out32, checks)
    phase_took("phase 4, the CLI path")

    # --- 5. parity
    print("parity: float64 on the card vs the plain CPU path, first 2 s:")
    head = signal[: int(2 * sr)]
    card64 = analyze(torch.as_tensor(head, device=dev), cfg)
    cpu64 = analyze(torch.as_tensor(head), cfg)
    compare_slice("f64 card vs cpu", card64, cpu64, sr, checks)
    print("LPC order 40 (--n-coeffs 40), float64 on the card vs the plain CPU path, first 1 s; order 127 into "
          "kernel D:")
    check_high_order_path(head[: int(sr)], cfg, checks, dev)
    phase_took("phase 5, float64 parity")

    print("parity: float32 vs float64 on the card, whole signal:")
    out64, cli64_launches = run_counted("CLI path float64", lambda: analyze(sig64, cfg))
    expect_launches("on the CLI path in float64", cli64_launches, ct_fused=0, viterbi=0, polish=0)
    check_budgets(out32, out64, signal, cfg, checks)
    del out64, card64, cpu64
    phase_took("phase 5, float32 budgets")

    # --- 6. the bench path: BENCH_44K as bench.py runs it (Viterbi off), and
    # bench_viterbi, with the path search, which the checks below run
    bcfg, bvcfg = BENCH_44K, with_viterbi(BENCH_44K)
    bframes64 = frame_signal(sig64, bcfg.frame_len, bcfg.hop)
    FB = bframes64.shape[0]
    print(f"bench path: {FB} frames of {bcfg.frame_len}, hop {bcfg.hop}, Viterbi off; bench_viterbi: Viterbi on")
    checks.true("bench frame count", FB == BENCH_FRAMES, f"{FB}")
    analyze(sig32[: 50 * bcfg.hop + bcfg.frame_len], bvcfg)
    torch.cuda.synchronize()
    bout32, bench_launches = run_counted("bench path float32", lambda: analyze(sig32, bcfg))
    expect_launches("on the bench path", bench_launches, viterbi=0)
    check_health("bench path", bout32, checks)
    bout32, bench_v_launches = run_counted("bench_viterbi path float32", lambda: analyze(sig32, bvcfg))
    expect_launches("on the bench_viterbi path", bench_v_launches)
    check_health("bench_viterbi path", bout32, checks)
    bout64 = analyze(sig64, bvcfg)
    path_errs["bench"], scan_runs["bench"] = check_path_kernels(
        "bench path", bframes64, bvcfg, {torch.float64: bout64, torch.float32: bout32}, checks)
    bench_args32 = bench_kernel_inputs(bframes64.float(), bout32, bvcfg)
    e_inputs = {"bench": bench_args32["ct_fused"]}  # kernel E's (frames, nfft) on each path, float32
    del bframes64
    phase_took("phase 6, bench path and its kernels vs plain")

    print("kernel F vs plain on its edge inputs:")
    check_viterbi_edges(checks, dev)
    phase_took("phase 6b, kernel F on edge inputs")

    print("bench path parity: float64 on the card vs the plain CPU path, first 2 s, Viterbi off and on:")
    for label, c in (("bench", bcfg), ("bench_viterbi", bvcfg)):
        compare_slice(f"{label} f64 card vs cpu", analyze(torch.as_tensor(head, device=dev), c),
                      analyze(torch.as_tensor(head), c), sr, checks)
    print("bench_viterbi path: float32 vs float64 on the card, whole signal, against the plain path:")
    plain = {dt: plain_periodic(one, TILES, bvcfg, dt, FB, dev) for dt in (torch.float32, torch.float64)}
    hold_budgets(
        "bench", bout32, bout64,
        lambda key, idx: frame_err(key, plain[torch.float32][key][idx], plain[torch.float64][key][idx],
                                   plain[torch.float64]["f0"][idx]),
        checks,
    )
    print("bench_viterbi path: analyze_long (chunks of 4096 frames) vs analyze, float64 on the card:")
    compare_slice("bench analyze_long vs analyze", analyze_long(sig64, bvcfg, chunk_frames=4096), bout64, sr, checks)
    del bout64, plain
    phase_took("phase 6, bench parity, budgets, analyze_long")

    # --- 7. the corpus block
    recs, lengths, block = corpus_block(one, sr)
    block64 = torch.as_tensor(block, device=dev)
    block32 = block64.float()
    corpus_s = sum(lengths) / sr
    cframes = [(n - bcfg.frame_len) // bcfg.hop + 1 for n in lengths]
    print(f"corpus block: {CORPUS_FILES} recordings, {corpus_s:.1f} s, {sum(cframes)} frames")
    cout64, corpus64_launches = run_counted(
        "corpus_viterbi block float64", lambda: analyze_batch_padded(block64, lengths, bvcfg))
    expect_launches("for the corpus_viterbi block in float64", corpus64_launches, polish=0)
    for b, r in enumerate(recs):
        row = {k: v[b, : cframes[b]] for k, v in cout64.items()}
        compare_slice(f"corpus row {b} vs analyze", row, analyze(torch.as_tensor(r, device=dev), bvcfg), sr, checks)
    check_health("corpus block", {k: torch.cat([v[b, : nf] for b, nf in enumerate(cframes)])
                                  for k, v in cout64.items()}, checks)
    # The block's frames as the path builds them: (16, F, n), each recording's
    # frames past its end zeroed; kernel D takes file_len = F.
    cfr64 = frame_signal(block64, bcfg.frame_len, bcfg.hop)
    cmask = torch.arange(cfr64.shape[1], device=dev)[None, :] < torch.as_tensor(cframes, device=dev)[:, None]
    cfr64 = cfr64 * cmask[:, :, None].double()
    _, corpus_launches = run_counted("corpus block float32", lambda: analyze_batch_padded(block32, lengths, bcfg))
    expect_launches("for the corpus block", corpus_launches, viterbi=0)
    cout32, corpus_v_launches = run_counted(
        "corpus_viterbi block float32", lambda: analyze_batch_padded(block32, lengths, bvcfg))
    expect_launches("for the corpus_viterbi block", corpus_v_launches)
    path_errs["corpus"], scan_runs["corpus"] = check_path_kernels(
        "corpus block", cfr64, bvcfg, {torch.float64: cout64, torch.float32: cout32}, checks, file_len=cfr64.shape[1])
    e_inputs["corpus"] = (hann_windowed(cfr64.float().reshape(-1, bcfg.frame_len)).contiguous(), 2 * bcfg.frame_len)
    del cout64, cout32, cfr64
    phase_took("phase 7, corpus block and its kernels vs plain")

    # --- 8. the flagship path: FLAGSHIP_44K (2048/512) as the reference
    # runs it (Viterbi off), flagship_viterbi with the path search, and
    # kernel E at every frame length its gate admits
    fcfg, fvcfg = FLAGSHIP_44K, with_viterbi(FLAGSHIP_44K)
    fframes64 = frame_signal(sig64, fcfg.frame_len, fcfg.hop)
    FF = fframes64.shape[0]
    print(f"flagship path: {FF} frames of {fcfg.frame_len}, hop {fcfg.hop}, Viterbi off; flagship_viterbi: on")
    analyze(sig32[: 50 * fcfg.hop + fcfg.frame_len], fvcfg)
    torch.cuda.synchronize()
    fout32, flag_launches = run_counted("flagship path float32", lambda: analyze(sig32, fcfg))
    expect_launches("on the flagship path", flag_launches, viterbi=0)
    check_health("flagship path", fout32, checks)
    fout32, flag_v_launches = run_counted("flagship_viterbi path float32", lambda: analyze(sig32, fvcfg))
    expect_launches("on the flagship_viterbi path", flag_v_launches)
    check_health("flagship_viterbi path", fout32, checks)
    path_errs["flagship"], scan_runs["flagship"] = check_path_kernels(
        "flagship path", fframes64, fvcfg, {torch.float64: analyze(sig64, fvcfg), torch.float32: fout32}, checks)
    e_inputs["flagship"] = (hann_windowed(fframes64.float()).contiguous(), 2 * fcfg.frame_len)
    del fframes64, fout32
    print("flagship_viterbi path parity: float64 on the card vs the plain CPU path, first 2 s:")
    compare_slice("flagship f64 card vs cpu", analyze(torch.as_tensor(head, device=dev), fvcfg),
                  analyze(torch.as_tensor(head), fvcfg), sr, checks)
    print("kernel E vs plain at every frame length its gate admits:")
    check_ct_fused_gate(checks, dev)
    phase_took("phase 8, flagship path and kernel E's gate")

    # --- the side process: phase 3d and the many-estimates `analyze`
    side_rc = side.wait()
    side_log.seek(0)
    print(f"side process (phase 3d; {MANY_ESTIMATES} estimates), exit {side_rc}:")
    print(side_log.read(), end="")
    checks.true("the side process's checks", side_rc == 0, f"(exit {side_rc})")
    phase_took("the side process, joined")

    # --- 9. the command line, float32, from IEEE-float WAVs
    from voxtpu_torch import cli

    ccfg = cli.build_analysis_config(sr)
    checks.true("cli.build_analysis_config(44100) == CLI_DEFAULT_44K", ccfg == cfg)
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_cli_") as tmpdir:
        tmp = Path(tmpdir)
        long_wav = tmp / "two_vowels_x126.wav"
        write_float_wav(long_wav, signal, sr)
        wav_dir = tmp / "corpus"
        wav_dir.mkdir()
        paths = [str(wav_dir / f"rec{b:02d}.wav") for b in range(CORPUS_FILES)]
        for pth, r in zip(paths, recs):
            write_float_wav(pth, r, sr)

        # `analyze` as a user runs it: a new process on the card.
        out_npz = tmp / "out.npz"
        cmd = [sys.executable, "-m", "voxtpu_torch", "analyze", str(long_wav), "-o", str(out_npz),
               "--bucket-frames", "0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        print(f"{' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s "
              f"(process start, CUDA init and the analysis); stderr: {proc.stderr.strip()[-1500:]}")
        if proc.returncode != 0:
            raise RuntimeError(f"python -m voxtpu_torch analyze failed with exit {proc.returncode}")
        got = npz_tensors(out_npz)
        checks.true("analyze npz keys", set(got) == set(out32), f"{sorted(got)}")
        compare_slice("python -m voxtpu_torch analyze vs analyze", got, out32, sr, checks)

        # `corpus --batch-files 16` in process, counted; then its reference:
        # `analyze_batch_padded` over the block the command builds (files in
        # the command's size order, the fine ladder's sample capacity).
        def corpus(out_dir):
            t = time.perf_counter()
            rc = cli.main(["corpus", *paths, "-o", str(out_dir), "--batch-files", "16", "--no-resume"])
            return rc, time.perf_counter() - t

        (rc, corpus_wall), cli_corpus_launches = run_counted(
            "corpus --batch-files 16 float32", lambda: corpus(tmp / "features"))
        checks.true("corpus exit 0", rc == 0, f"({rc})")
        expect_launches("for the corpus command's block", cli_corpus_launches, ct_fused=0, viterbi=0)
        manifest = json.loads((tmp / "features" / "manifest.json").read_text())
        nfr = [num_frames(len(r), ccfg.frame_len, ccfg.hop) for r in recs]
        checks.true("corpus manifest: 16 files, status 0, frame counts",
                    sorted(manifest) == sorted(paths)
                    and all(manifest[pth]["status_nonzero"] == 0 and manifest[pth]["frames"] == nf
                            for pth, nf in zip(paths, nfr)), f"{[manifest[pth]['frames'] for pth in paths]}")
        order = sorted(range(CORPUS_FILES), key=lambda b: os.path.getsize(paths[b]))
        Fmax = cli._bucket_target_fine(max(nfr), cli._resolve_bucket(argparse.Namespace(bucket_frames=None, f64=False)))
        S = (Fmax - 1) * ccfg.hop + ccfg.frame_len
        stacked = np.zeros((CORPUS_FILES, S), np.float32)
        for i, b in enumerate(order):
            stacked[i, : min(len(recs[b]), S)] = recs[b][:S]
        ref = analyze_batch_padded(torch.as_tensor(stacked, device=dev),
                                   [min(len(recs[b]), S) for b in order], ccfg)
        for i, b in enumerate(order):
            got = npz_tensors(tmp / "features" / f"rec{b:02d}.npz")
            compare_slice(f"corpus file {b} vs its block row", got,
                          {k: v[i, : nfr[b]] for k, v in ref.items()}, sr, checks)
        del ref
        rc2, corpus_warm = corpus(tmp / "features_again")
        checks.true("corpus (second run) exit 0", rc2 == 0, f"({rc2})")
        # The command's share spent reading: the same 16 reads through its
        # reader, files cached as they were for the second run.
        t = time.perf_counter()
        for pth in paths:
            cli._read(pth, np.float32)
        corpus_reads = time.perf_counter() - t
    for label, wall in (("first", corpus_wall), ("second", corpus_warm)):
        print(f"corpus --batch-files 16, {label} run: {wall:.3f} s wall for {corpus_s:.1f} s of audio, reads "
              f"and writes included = {corpus_s / wall:.1f} audio-s/s [{card}]")
    print(f"corpus reads alone (cli._read of the 16 WAVs): {corpus_reads:.4f} s = "
          f"{100 * corpus_reads / corpus_warm:.1f}% of the second run [{card}]")
    phase_took("phase 9, the command line")

    # --- 10. times (float32): each path with kernel P, and before it, with
    # the polish as the plain version's eager ops (`eager_polish`)
    runs = {
        "cli": (lambda: analyze(sig32, cfg), audio_s),
        "bench": (lambda: analyze(sig32, bcfg), audio_s),
        "bench_viterbi": (lambda: analyze(sig32, bvcfg), audio_s),
        "corpus": (lambda: analyze_batch_padded(block32, lengths, bcfg), corpus_s),
        "corpus_viterbi": (lambda: analyze_batch_padded(block32, lengths, bvcfg), corpus_s),
        "flagship": (lambda: analyze(sig32, fcfg), audio_s),
        "flagship_viterbi": (lambda: analyze(sig32, fvcfg), audio_s),
    }
    launches_by_path = {
        "cli": cli_launches, "bench": bench_launches, "bench_viterbi": bench_v_launches,
        "corpus": corpus_launches, "corpus_viterbi": corpus_v_launches, "flagship": flag_launches,
        "flagship_viterbi": flag_v_launches, "corpus_command": cli_corpus_launches,
    }
    e2e, e2e_eager, profs, profs_eager = {}, {}, {}, {}
    for path, (fn, secs) in runs.items():
        with eager_polish():
            e2e_eager[path] = sync_ms(fn)
        e2e[path] = sync_ms(fn)
        print(f"end to end, float32, {path} path: {e2e[path]:.2f} ms for {secs:.1f} s of audio = "
              f"{secs / (e2e[path] / 1e3):.1f} audio-s/s; before P (eager polish) {e2e_eager[path]:.2f} ms [{card}]")
    # Each trace must hold each kernel as often as the path's counted run
    # launched it (none of P before it).
    want = {path: {act: launches_by_path[path][name] for name, act in TRACED_ACTIVITIES} for path in runs}
    for path, (fn, _secs) in runs.items():
        with eager_polish():
            profs_eager[path] = profile_path(f"{path} path, before P (eager polish)", fn, card,
                                             {**want[path], KERNEL_ACTIVITY["polish"]: 0}, top=4)
        # The CLI path's every activity name: what is left on the host.
        profs[path] = profile_path(f"{path} path", fn, card, want[path], top=None if path == "cli" else 12)
    for path, after in profs.items():
        before = profs_eager[path]
        print(f"{path} path, before -> after P [{card}]: device activities {before['activities']} -> "
              f"{after['activities']}; busy {before['busy_ms']:.3f} -> {after['busy_ms']:.3f} ms; idle share "
              f"{before['idle']:.4f} -> {after['idle']:.4f}; end to end {e2e_eager[path]:.2f} -> {e2e[path]:.2f} ms")

    for path in runs:
        for label, prof, polish_count in ((f"{path} path profile before P", profs_eager[path], 0),
                                          (f"{path} path profile", profs[path], 1)):
            got = kernel_counts(prof)
            for name, activity in TRACED_ACTIVITIES:
                n = polish_count if name == "polish" else launches_by_path[path][name]
                checks.true(f"{label}: {activity} {n} time(s)", got[activity] == n,
                            f"({got[activity]}; trace {prof['traces']} of at most {PROFILE_TRACES})")
    checks.true("CLI-path profile: at most 1,000 device activities", profs["cli"]["activities"] <= 1000,
                f"({profs['cli']['activities']})")

    args32, _ = kernel_inputs(frame_signal(sig32, cfg.frame_len, cfg.hop), cfg)
    a_stats = scan_runs["cli"][torch.float32]["refine_stats"]  # phase 3's, on the same values
    bounds = kernel_bounds(args32, bench_args32, a_stats)
    prefix = 256  # the plain scan is a Python loop over frames: time a prefix
    vprefix = 1024  # so is the plain DP
    rf, rb, ef, eb = args32["formant_scan"]
    xe, nfft = bench_args32["ct_fused"]
    lv, fv, vv, ojc, vuc = bench_args32["viterbi"]

    timing = {
        "refine": (lambda: refine.refine(*args32["refine"]), lambda: refine.refine_plain(*args32["refine"]), F, None),
        "burg": (lambda: burg.burg(*args32["burg"]), lambda: burg.burg_plain(*args32["burg"]), F, None),
        "find_roots": (lambda: find_roots.find_roots(*args32["find_roots"]),
                       lambda: find_roots.find_roots_plain(*args32["find_roots"]), F, None),
        "formant_scan": (lambda: formant_scan.formant_scan(rf, rb, ef, eb),
                         lambda: formant_scan.formant_scan_plain(rf[:prefix], rb[:prefix], ef, eb), prefix, None),
        "ct_fused": (lambda: ct_fused.ct_fused_power_ac(xe, nfft), lambda: ct_fused.ct_fused_power_ac_plain(xe, nfft),
                     FB, lambda: cufft_power_ac(xe, nfft)),
        "viterbi": (lambda: viterbi.viterbi_path(lv, fv, vv, ojc, vuc),
                    lambda: viterbi.viterbi_path_plain(lv[:vprefix], fv[:vprefix], vv[:vprefix], ojc, vuc), vprefix, None),
        "pitch_pre": (lambda: pitch_pre.pitch_pre(*bench_args32["pitch_pre"]),
                      lambda: pitch_pre.pitch_pre_plain(*bench_args32["pitch_pre"]), FB, None),
        # plain: the eager ops the CLI path ran before P
        "polish": (lambda: polish.polish_roots(*args32["polish"]),
                   lambda: polish.polish_roots_plain(*args32["polish"]), F, None),
    }
    rows = []
    for name, (kfn, pfn, plain_frames, lfn) in timing.items():
        src, replaces, path = KERNELS[name]
        checked = path.removesuffix("_viterbi")  # the path whose kernel checks hold its errors
        frames_k = F if path == "cli" else FB
        ms = event_ms(kfn)
        plain_ms = event_ms(pfn, runs=1 if plain_frames < frames_k else 3)
        library_ms = event_ms(lfn) if lfn is not None else None
        bound_ms, bound_by = bounds[name]
        launches = launches_by_path[path][name]
        print(f"  {name}: kernel {ms:.3f} ms ({frames_k} frames, {path} path), plain {plain_ms:.3f} ms "
              f"({plain_frames} frames), library {'none' if library_ms is None else f'{library_ms:.3f} ms'}, "
              f"bound {bound_ms:.4f} ms by {bound_by}, {launches} launch(es) on the {path} path")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": path_errs[checked][torch.float32][name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "max_abs_err_f64": path_errs[checked][torch.float64][name], "path": path, "frames": frames_k,
            "plain_frames": plain_frames,
            "launches_by_path": {p: counts[name] for p, counts in launches_by_path.items()},
            "max_abs_err_by_path": {p: {"f32": e[torch.float32][name], "f64": e[torch.float64][name]}
                                    for p, e in path_errs.items() if name in e[torch.float32]},
        })
    # G at the CLI path's shapes too (35,689 frames of 2205).
    g_cli = {"cli_ms": event_ms(lambda: pitch_pre.pitch_pre(*args32["pitch_pre"])),
             "cli_plain_ms": event_ms(lambda: pitch_pre.pitch_pre_plain(*args32["pitch_pre"]), runs=3),
             "cli_bound_ms": pitch_pre_bound(args32["pitch_pre"])[0], "cli_frames": F}
    print(f"  pitch_pre at the CLI path's shapes: kernel {g_cli['cli_ms']:.3f} ms, plain "
          f"{g_cli['cli_plain_ms']:.3f} ms, bound {g_cli['cli_bound_ms']:.4f} ms by bytes ({F} frames)")
    next(r for r in rows if r["name"] == "pitch_pre").update(g_cli)
    # D on each path: its time at that path's shapes, and the call's chunks,
    # the share whose speculation held and the frames re-run in repair.
    d_paths = {}
    for path, label in PATHS.items():
        run = scan_runs[path][torch.float32]
        drf, drb, def_, deb, dfl = run["args"]
        chunks, rerun, frames_rerun = run["stats"]
        d_paths[path] = {
            "ms": event_ms(lambda: formant_scan.formant_scan(drf, drb, def_, deb, file_len=dfl)),
            "bound_ms": formant_scan_bound(drf, def_.shape[0])[0], "frames": len(drf),
            "launches": launches_by_path[path]["formant_scan"], "chunks": chunks,
            "held_share": (chunks - rerun) / chunks, "frames_rerun": frames_rerun,
            "stats_f64": scan_runs[path][torch.float64]["stats"],
        }
        v = d_paths[path]
        print(f"  formant_scan, {label}: kernel {v['ms']:.3f} ms ({v['frames']} frames), bound {v['bound_ms']:.4f} ms, "
              f"{v['launches']} launch(es); {scan_stats_text(run['stats'])} (float64: "
              f"{scan_stats_text(v['stats_f64'])})")
    d_row = next(r for r in rows if r["name"] == "formant_scan")
    d_row.update({k: d_paths["cli"][k] for k in ("chunks", "held_share", "frames_rerun")})
    d_row["by_path"] = d_paths
    # A at the CLI path's shapes (the row above) and at the bench and
    # flagship shapes in float32, and at the CLI path's shapes in float64,
    # each beside its bound, its plain version and its stats.
    a_row = next(r for r in rows if r["name"] == "refine")
    a_row["stats"] = a_stats
    a_cases = {"bench": scan_runs["bench"][torch.float32], "flagship": scan_runs["flagship"][torch.float32],
               "cli, float64": scan_runs["cli"][torch.float64]}
    a_paths = {}
    for label, run in a_cases.items():
        ra, st = run["refine_args"], run["refine_stats"]
        path = label.split(",")[0]
        bound_ms, bound_by = refine_bound(ra, st)
        a_paths[label] = {
            "ms": event_ms(lambda: refine.refine(*ra)),
            "plain_ms": event_ms(lambda: refine.refine_plain(*ra), runs=1 if ra[0].dtype == torch.float64 else 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "frames": len(ra[0]), "stats": st,
            "launches": launches_by_path[path]["refine"],
        }
        v = a_paths[label]
        print(f"  refine, {label}: kernel {v['ms']:.3f} ms ({v['frames']} frames), plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound_ms']:.4f} ms by {v['bound_by']}; {refine_stats_text(st, int(ra[2].sum()))}; "
              f"{v['launches']} launch(es) on the {path} path [{card}]")
    print(f"  refine, CLI path: {refine_stats_text(a_stats, int(args32['refine'][2].sum()))} [{card}]")
    a_row["by_path"] = a_paths
    # B at the CLI path's shapes (the row above), the bench and flagship
    # shapes, and the CLI path's in float64, each beside its plain version,
    # its bound by operations and its bound with the float -> double
    # conversions at the rate measured here, with the launch the wrapper
    # picks.
    b_row = next(r for r in rows if r["name"] == "burg")
    cvt_rate = probe_rates(rates_lib, ("cvt_f64_f32",), card)
    cvt_per_clock_sm = cvt_rate["cvt_f64_f32"]["per_clock_sm"]
    cvt_s = cvt_rate["sms"] * cvt_per_clock_sm * PEAK_SM_HZ
    b_cases = {"cli": scan_runs["cli"][torch.float32], "bench": scan_runs["bench"][torch.float32],
               "flagship": scan_runs["flagship"][torch.float32], "cli, float64": scan_runs["cli"][torch.float64]}
    b_paths = {}
    for label, run in b_cases.items():
        bx, bp = run["burg_args"]
        path = label.split(",")[0]
        bound_cvt_ms, bound_cvt_by = burg_bound(bx, bp, cvt_s)
        b_paths[label] = {
            "ms": event_ms(lambda: burg.burg(bx, bp)),
            "plain_ms": event_ms(lambda: burg.burg_plain(bx, bp), runs=3),
            "bound_ms": burg_bound(bx, bp)[0], "bound_cvt_ms": bound_cvt_ms, "bound_by": bound_cvt_by,
            "frames": len(bx), "n": bx.shape[1], "launch": burg.launch_config(bx.shape[1], bx.dtype)._asdict(),
            "launches": launches_by_path[path]["burg"],
        }
        v = b_paths[label]
        print(f"  burg, {label}: kernel {v['ms']:.3f} ms ({v['frames']} frames of {v['n']}, {v['launch']}), plain "
              f"{v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms by operations, {v['bound_cvt_ms']:.4f} ms with "
              f"the conversions (by {v['bound_by']}); {v['launches']} launch(es) on the {path} path [{card}]")
    b_row.update(bound_cvt_ms=b_paths["cli"]["bound_cvt_ms"], cvt_per_clock_sm=cvt_per_clock_sm, by_path=b_paths)
    # C at the CLI path's shapes (the row above), the bench and flagship
    # shapes, and the CLI path's in float64, each beside its plain version,
    # its bound by operations and its floor by instruction issue, counted
    # from one Laguerre iteration's SASS (`roots_loops`, `roots_issue_floor`).
    c_row = next(r for r in rows if r["name"] == "find_roots")
    c_loops = roots_loops(lib_path, args32["find_roots"][0].shape[1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c_cases = {"cli": scan_runs["cli"][torch.float32], "bench": scan_runs["bench"][torch.float32],
               "flagship": scan_runs["flagship"][torch.float32], "cli, float64": scan_runs["cli"][torch.float64]}
    c_paths = {}
    for label, run in c_cases.items():
        rc = run["roots_args"]
        path = label.split(",")[0]
        dname = "f64" if rc[0].dtype == torch.float64 else "f32"
        loop = c_loops[dname]
        floor = roots_issue_floor(*rc, loop["instructions"], sms, loop["float64"] if dname == "f64" else 0) \
            if loop else None
        bound_ms, bound_by = roots_bound(rc[0])
        c_paths[label] = {
            "ms": c_row["ms"] if label == "cli" else event_ms(lambda: find_roots.find_roots(*rc)),
            "plain_ms": c_row["plain_ms"] if label == "cli" else event_ms(lambda: find_roots.find_roots_plain(*rc),
                                                                           runs=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "issue_floor_ms": floor, "laguerre_sass": loop,
            "frames": len(rc[0]), "launches": launches_by_path[path]["find_roots"],
        }
        v = c_paths[label]
        text = "no cuobjdump" if floor is None else (
            f"issue floor {floor[0]:.4f} ms even, {floor[1]:.4f} on the busiest scheduler ({loop['instructions']} "
            f"SASS instructions an iteration, {loop['float64']} float64)")
        print(f"  find_roots, {label}: kernel {v['ms']:.3f} ms ({v['frames']} frames), plain {v['plain_ms']:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by}; {text}; {v['launches']} launch(es) on the {path} path [{card}]")
    c_row["by_path"] = c_paths
    # E at each path's shapes beside its bound, its plain version and cuFFT;
    # and in float64 at the bench shapes (its frames in float64).
    e_paths = {}
    for path, (x, nf) in e_inputs.items():
        e_paths[path] = {
            "ms": event_ms(lambda: ct_fused.ct_fused_power_ac(x, nf)),
            "plain_ms": event_ms(lambda: ct_fused.ct_fused_power_ac_plain(x, nf)),
            "library_ms": event_ms(lambda: cufft_power_ac(x, nf)),
            "bound_ms": ct_fused_bound(x, nf)[0], "bound_by": ct_fused_bound(x, nf)[1], "frames": x.shape[0],
            "n": x.shape[1], "launches": launches_by_path[path]["ct_fused"],
        }
        v = e_paths[path]
        print(f"  ct_fused, {PATHS[path]}: kernel {v['ms']:.3f} ms ({v['frames']} frames of {v['n']}), plain "
              f"{v['plain_ms']:.3f} ms, cuFFT rfft-power-irfft {v['library_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"by {v['bound_by']}, {v['launches']} launch(es) [{card}]")
    x64 = xe.double()
    e64 = {"ms": event_ms(lambda: ct_fused.ct_fused_power_ac(x64, nfft)),
           "plain_ms": event_ms(lambda: ct_fused.ct_fused_power_ac_plain(x64, nfft)),
           "library_ms": event_ms(lambda: cufft_power_ac(x64, nfft)),
           "bound_ms": ct_fused_bound(x64, nfft)[0], "frames": FB}
    print(f"  ct_fused, bench path, float64: kernel {e64['ms']:.3f} ms, plain {e64['plain_ms']:.3f} ms, cuFFT "
          f"rfft-power-irfft {e64['library_ms']:.3f} ms, bound {e64['bound_ms']:.4f} ms [{card}]")
    del x64
    e_row = next(r for r in rows if r["name"] == "ct_fused")
    e_row["by_path"] = e_paths
    e_row["f64_bench"] = e64
    # F: its pre-pass and chain apart, and their sum, in each _viterbi
    # path's trace above; at the bench_viterbi shapes, in both dtypes, its
    # time, the chain's clocks a step and its floor (thread 0's clocks
    # outside its waits for a record) and its bound.
    f_row = next(r for r in rows if r["name"] == "viterbi")
    f_split = {}
    for path in ("bench_viterbi", "corpus_viterbi", "flagship_viterbi"):
        split = {act: sum(us for name, (_c, us) in profs[path]["by_name"].items() if act in name) / 1e3
                 for act in ("viterbi_costs", "viterbi_chain")}
        f_split[f"{path} trace"] = split
        print(f"  viterbi in the {path} path's trace: pre-pass {split['viterbi_costs']:.3f} ms + chain "
              f"{split['viterbi_chain']:.3f} ms = {sum(split.values()):.3f} ms [{card}]")
    vb64 = bench_kernel_inputs(frame_signal(sig64, bcfg.frame_len, bcfg.hop), analyze(sig64, bvcfg), bvcfg)["viterbi"]
    for label, va in {"bench_viterbi": (lv, fv, vv), "bench_viterbi, float64": vb64[:3]}.items():
        b3 = [t[None] for t in va]
        clocks = torch.zeros(8, dtype=torch.int64, device=dev)
        viterbi._launch(*b3, ojc, vuc, stamps=clocks)
        loop, wait, steps, ns, *parts = (int(v) for v in clocks.cpu())
        ghz = loop / ns
        bound_ms, bound_by = viterbi_bound(va[0])
        config = viterbi.launch_config(1, *va[0].shape, va[0].dtype)
        f_split[label] = {
            "ms": f_row["ms"] if label == "bench_viterbi" else event_ms(lambda: viterbi.viterbi_path(*va, ojc, vuc)),
            "one_chunk_ms": event_ms(lambda: viterbi._launch(*b3, ojc, vuc, steps=b3[0].shape[1] - 1)),
            "step_clocks": loop / steps, "wait_clocks": wait / steps, "sm_ghz": ghz,
            "chain_floor_ms": (loop - wait) / ghz / 1e6,
            "part_clocks": dict(zip(("argmax", "combine", "stores", "barrier"), (p / steps for p in parts))),
            "bound_ms": bound_ms, "bound_by": bound_by, "records_ms": viterbi_records_ms(va[0]),
            "frames": va[0].shape[0], "steps_a_chunk": config.steps, "scratch_bytes": config.scratch,
        }
        v = f_split[label]
        print(f"  viterbi, {label}: {v['ms']:.3f} ms, {v['one_chunk_ms']:.3f} ms with every step in one chunk; chain "
              f"{v['step_clocks']:.1f} clocks a step, {v['wait_clocks']:.1f} of them waiting for a record, "
              f"{', '.join(f'{k} {c:.1f}' for k, c in v['part_clocks'].items())}, at {ghz:.3f} GHz: chain floor "
              f"{v['chain_floor_ms']:.3f} ms; bound {bound_ms:.4f} ms by {bound_by}; records written and read "
              f"{v['records_ms']:.4f} ms ({config.steps} steps a chunk, {v['scratch_bytes']} bytes of scratch) "
              f"[{card}]")
    trace = f_split["bench_viterbi trace"]
    f_row.update(prepass_ms=trace["viterbi_costs"], chain_ms=trace["viterbi_chain"],
                 chain_floor_ms=f_split["bench_viterbi"]["chain_floor_ms"],
                 records_ms=f_split["bench_viterbi"]["records_ms"], by_path=f_split)
    # P's bound beside the bound of the plain version's 1 + 2 iters passes.
    p_row = next(r for r in rows if r["name"] == "polish")
    p_row["bound_plain_passes_ms"] = polish_bound(args32["polish"], passes_per_iter=2)[0]
    print(f"  polish, CLI path: kernel {p_row['ms']:.4f} ms, bound {p_row['bound_ms']:.4f} ms (1 + iters passes a "
          f"live slot), {p_row['bound_plain_passes_ms']:.4f} at the plain version's 1 + 2 iters [{card}]")

    phase_took("phase 10, times")

    # --- 11. serve: the HTTP daemon on the card, its launches counted per run
    serve = check_serve(one, sr, card, checks, run_counted, dev)
    for row in rows:
        row["launches_by_path"]["serve"] = serve["total"][row["name"]]
    phase_took("phase 11, serve")

    # --- 12. sharded analysis over meshes that list the one card
    sharded = check_sharded(sig32, recs, lengths, card, checks, run_counted, dev)
    for row in rows:
        row["launches_by_path"]["sharded"] = sharded["total"][row["name"]]
    phase_took("phase 12, sharded")

    # --- 13. bench: voxtpu_torch.bench in process, then as a command
    bench_numbers = check_bench(card, checks, run_counted, expect_launches, dev)
    cmd_line = bench_numbers["command"]
    print(f"python -m voxtpu_torch bench: {json.dumps(cmd_line)}; beside phase 10's bench path row: "
          f"{e2e['bench']:.2f} ms end to end for {audio_s:.1f} s of audio [{card}]")
    phase_took("phase 13, bench")

    # --- 14. the autocorrelation backends at the bench shapes: X3, "ct", E
    x3_row, e16 = check_autocorr_backends(xe, nfft, sig32, build_log, card, checks, run_counted, dev)
    rows.append(x3_row)
    e_pfa = check_ct_fused_pfa(sig32, build_log, card, checks)
    phase_took("phase 14, the autocorrelation backends")

    # --- 15. the examples on the card
    example_numbers = check_examples(checks, run_counted)
    phase_took("phase 15, the examples")

    # --- 16. frames of 16,384 and 32,768: E and B over thread-block clusters
    large = check_large_frames(signal, sig32, sig64, card, checks, run_counted, expect_launches, cvt_s, build_log,
                               dev)
    e_row["shapes"] = {"n16384_f32": {**e16, "launches": large["paths"][16384]["launches"]["ct_fused"]},
                       **large["ct_fused"], **e_pfa}
    b_row["shapes"] = large["burg"]
    for row in rows:
        for n in LARGE_NS:
            row["launches_by_path"][f"large_{n}"] = large["paths"][n]["launches"][row["name"]]
    phase_took("phase 16, frames of 16,384 and 32,768")
    print(f"[chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check]")
    checks.raise_failures()

    def device(p):
        return {k: p[k] for k in ("busy_ms", "span_ms", "idle", "activities", "traces")}

    print(json.dumps({"e2e_ms": e2e, "audio_s_per_s": {k: runs[k][1] / (v / 1e3) for k, v in e2e.items()},
                      "device": {k: device(v) for k, v in profs.items()},
                      "before_p": {"e2e_ms": e2e_eager, "device": {k: device(v) for k, v in profs_eager.items()}},
                      "frames": {"cli": F, "bench": FB, "corpus": sum(cframes), "flagship": FF},
                      "corpus_command_s": {"first": corpus_wall, "second": corpus_warm},
                      "serve": {**serve["numbers"], "launches": serve["launches"]},
                      "sharded": {**sharded["numbers"], "launches": sharded["launches"]},
                      "bench": bench_numbers, "examples": example_numbers,
                      "large": {str(n): {k: v for k, v in p.items() if not k.startswith("launches")}
                                for n, p in large["paths"].items()}, "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--side"]:
        side_checks()
    elif sys.argv[1:2] == ["--kernel-e"] and len(sys.argv) <= 3:
        kernel_e_alone(Path(sys.argv[2]) if len(sys.argv) == 3 else ROOT)
    else:
        main()
