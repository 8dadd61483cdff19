"""Kernel D's schedule and its every-frame check, on the CPU.

csrc/formant_scan.cu runs the McCandless scan as a chunked speculative scan
with exact repair; it runs on the card only. Here:

- `_speculate_repair`, a plain PyTorch model of that schedule (every chunk
  stepped from the seed after a warm-up, batched over chunks; then, per
  recording and in order, each chunk whose entry carry differs bit for bit
  from the output before it is re-run until its carry meets the stored
  output), equals `formant_scan_plain` bit for bit for several (chunk,
  warm-up) pairs, the kernel's own included, on 1,000 frames of the
  two-vowels recording's resonances at CLI_DEFAULT_44K, on chip_smoke.py's
  adversarial cases (a)-(d) at small sizes, and at its other shapes (R from
  1 to 100, L from 1 to 16);
- `formant_scan_check` finds no frame on `formant_scan_plain`'s output (both
  dtypes, with and without file_len), and reports t first when one value
  of frame t changes;
- `formant_scan_plain` equals voxtpu's plain tracker
  (`formant_tracker(backend="jnp")`) bit for bit on zero spans and a NaN row.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from voxtpu.formants import formant_tracker as jax_tracker

from chip_smoke import scan_shape_cases, scan_stress_cases
from voxtpu_torch.formants import estimate_formants_step, formant_candidates
from voxtpu_torch.frame import frame_signal
from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.ops import formant_scan as fs
from voxtpu_torch.pipeline import CLI_DEFAULT_44K

jax_tracker = jax.jit(jax_tracker, static_argnames="backend")

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "voxtpu_torch", "csrc", "formant_scan.cu")
FRAMES = 1000
# (chunk, warm-up): the kernel's own, then shorter ones that leave many
# chunks to repair, no warm-up at all, and a warm-up longer than a chunk.
SCHEDULES = [(fs.CHUNK, fs.WARMUP), (8, 4), (16, 0), (5, 12)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def _same_bits(a, b) -> bool:
    return torch.equal(_bits(a), _bits(b))


def _seed(dt):
    cfg = CLI_DEFAULT_44K.formant
    est = torch.as_tensor(cfg.estimates, dtype=dt)
    return est, torch.full_like(est, cfg.estimate_bandwidth)


@pytest.fixture(scope="module")
def two_vowels():
    """The CLI path's float32 resonances of the first FRAMES frames of the
    two-vowels recording tiled, as chip_smoke.py builds them."""
    cfg = CLI_DEFAULT_44K
    one = np.asarray(read_wav(os.path.join(FIX, "sample-two_vowels.wav")).samples, dtype=np.float64)
    n = (FRAMES - 1) * cfg.hop + cfg.frame_len
    sig = np.tile(one, -(-n // len(one)))[:n]
    frames = frame_signal(torch.as_tensor(sig, dtype=torch.float32), cfg.frame_len, cfg.hop)
    rf, rb, _ = formant_candidates(frames, cfg.sample_rate, cfg.formant.n_coeffs, polish=cfg.formant.polish)
    assert rf.shape == (FRAMES, 32)
    return rf, rb


def _speculate_repair(rf, rb, ef, eb, file_len, chunk, warmup):
    """Kernel D's schedule in plain PyTorch. Returns (out_f, out_b,
    (chunks, chunks re-run, frames re-run))."""
    F, L = rf.shape[0], ef.shape[0]
    files, per_file = F // file_len, -(-file_len // chunk)
    start = torch.arange(files).repeat_interleave(per_file) * file_len
    t0 = start + torch.arange(per_file).repeat(files) * chunk
    t1 = torch.minimum(t0 + chunk, start + file_len)
    tw = torch.maximum(t0 - warmup, start)
    n = len(t0)

    # Speculate: every chunk at once, from the seed at tw.
    cf, cb = ef.expand(n, L).clone(), eb.expand(n, L).clone()
    out_f = torch.empty((F, L), dtype=rf.dtype)
    out_b = torch.empty_like(out_f)
    for i in range(-warmup, chunk):
        if i == 0:
            spec_f, spec_b = cf.clone(), cb.clone()
        t = t0 + i
        live = (t >= tw) & (t < t1)
        tc = t.clamp(0, F - 1)
        nf, nb = estimate_formants_step(cf, cb, rf[tc], rb[tc])
        cf = torch.where(live[:, None], nf, cf)
        cb = torch.where(live[:, None], nb, cb)
        if i >= 0:
            out_f[t[live]] = cf[live]
            out_b[t[live]] = cb[live]

    # Repair: per recording, chunk after chunk.
    rerun_chunks = rerun_frames = 0
    for f in range(files):
        running = False
        for k in range(per_file):
            c = f * per_file + k
            a, b = int(t0[c]), int(t1[c])
            if not running:
                if int(tw[c]) == int(start[c]):
                    continue  # the warm-up began at the recording's first frame: exact
                if _same_bits(spec_f[c], out_f[a - 1]) and _same_bits(spec_b[c], out_b[a - 1]):
                    continue
                carry = out_f[a - 1].clone(), out_b[a - 1].clone()
                running = True
            rerun_chunks += 1
            for t in range(a, b):
                carry = estimate_formants_step(*carry, rf[t], rb[t])
                rerun_frames += 1
                if _same_bits(carry[0], out_f[t]) and _same_bits(carry[1], out_b[t]):
                    running = False
                    break
                out_f[t], out_b[t] = carry
    return out_f, out_b, (n, rerun_chunks, rerun_frames)


@pytest.fixture(scope="module")
def plain():
    """formant_scan_plain, once per named input across the tests."""
    cache = {}

    def run(name, rf, rb, ef, eb, file_len):
        key = (name, rf.dtype, rf.shape, file_len)
        if key not in cache:
            cache[key] = fs.formant_scan_plain(rf, rb, ef, eb, file_len=file_len)
        return cache[key]

    return run


@pytest.mark.parametrize("kind", ["two_vowels", "(a)", "(b)", "(c)", "(d)"])
@pytest.mark.parametrize("chunk, warmup", SCHEDULES)
def test_schedule_model_equals_plain_scan(two_vowels, plain, kind, chunk, warmup):
    if kind == "two_vowels":
        cases = [("two_vowels", *two_vowels, FRAMES)]
    else:
        small = scan_stress_cases(*two_vowels, chunk, span=40, uniform=300, block=4)
        cases = [c for c in small if c[0].startswith(kind)]
    assert cases
    ef, eb = _seed(torch.float32)
    for name, rf, rb, file_len in cases:
        got_f, got_b, (chunks, rerun_chunks, rerun_frames) = _speculate_repair(rf, rb, ef, eb, file_len, chunk, warmup)
        want_f, want_b = plain(name, rf, rb, ef, eb, file_len)
        assert _same_bits(got_f, want_f) and _same_bits(got_b, want_b), name
        assert chunks == rf.shape[0] // file_len * -(-file_len // chunk)
        assert rerun_chunks <= chunks and rerun_frames <= rf.shape[0]
        if warmup >= file_len:
            assert rerun_chunks == 0, name  # every warm-up reaches its recording's start
        if kind == "(a)" and warmup < 40:
            assert rerun_frames >= 2 * 40, name  # the held carry is re-run through the spans


@pytest.mark.parametrize("chunk, warmup", SCHEDULES)
def test_schedule_model_equals_plain_scan_at_other_shapes(two_vowels, plain, chunk, warmup):
    for name, rf, rb, ef, eb in scan_shape_cases(*two_vowels, frames=120):
        for file_len in (120, 24):
            got_f, got_b, _ = _speculate_repair(rf, rb, ef, eb, file_len, chunk, warmup)
            want_f, want_b = plain(name, rf, rb, ef, eb, file_len)
            assert _same_bits(got_f, want_f) and _same_bits(got_b, want_b), (name, file_len)


def test_schedule_model_speculation_holds_on_speech(two_vowels):
    """With the kernel's constants most chunks of speech enter with the true
    carry (the bound the card's repair pass relies on for its speed)."""
    ef, eb = _seed(torch.float32)
    _, _, (chunks, rerun_chunks, rerun_frames) = _speculate_repair(*two_vowels, ef, eb, FRAMES, fs.CHUNK, fs.WARMUP)
    assert chunks == -(-FRAMES // fs.CHUNK)
    assert rerun_chunks <= chunks // 4 and rerun_frames <= FRAMES // 4


def test_wrapper_runs_the_plain_scan_on_the_cpu(two_vowels):
    """CPU tensors take `formant_scan_plain`; repair counts exist only for a
    launch, so asking for them on the CPU raises."""
    rf, rb = (x[:200] for x in two_vowels)
    ef, eb = _seed(torch.float32)
    got = fs.formant_scan(rf, rb, ef, eb, file_len=50)
    want = fs.formant_scan_plain(rf, rb, ef, eb, file_len=50)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fs.formant_scan(rf, rb, ef, eb, stats=torch.zeros(3, dtype=torch.int64))


def test_constants_mirror_the_cuda_source():
    src = open(SRC).read()
    for name, value in (("kChunk", fs.CHUNK), ("kWarmup", fs.WARMUP), ("kMaxL", fs._MAX_L)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
    assert re.search(r"constexpr int kSpec = 2 \* kSlots;", src) and fs._SPEC == 12


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("file_len", [None, 125])
def test_check_finds_no_frame_on_plain_output(two_vowels, plain, dt, file_len):
    rf, rb = (t.to(dt) for t in two_vowels)
    ef, eb = _seed(dt)
    out = plain("two_vowels", rf, rb, ef, eb, file_len)
    assert fs.formant_scan_check(rf, rb, ef, eb, *out, file_len=file_len).numel() == 0


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("t, which, col", [(0, 0, 0), (437, 0, 2), (500, 1, 3), (999, 1, 0)])
def test_check_reports_the_changed_frame_first(two_vowels, plain, dt, t, which, col):
    rf, rb = (x.to(dt) for x in two_vowels)
    ef, eb = _seed(dt)
    out = [x.clone() for x in plain("two_vowels", rf, rb, ef, eb, 125)]
    out[which][t, col] = torch.nextafter(out[which][t, col], torch.tensor(np.inf, dtype=dt))
    bad = fs.formant_scan_check(rf, rb, ef, eb, *out, file_len=125)
    assert bad.numel() >= 1 and int(bad[0]) == t


def test_check_tells_signed_zeros_and_matches_nan():
    """Bits, not ==: -0.0 in place of 0.0 is a difference, a NaN output
    equal to the step's NaN is not. All-zero rows hold the seed."""
    rf = torch.zeros((3, 4))
    rb = torch.ones_like(rf)
    ef = torch.tensor([float("nan"), 0.0])
    eb = torch.ones(2)
    out = fs.formant_scan_plain(rf, rb, ef, eb)
    assert fs.formant_scan_check(rf, rb, ef, eb, *out).numel() == 0
    flipped = out[0].clone()
    zero = flipped == 0
    assert bool(zero.any())
    flipped[zero] = -0.0
    assert fs.formant_scan_check(rf, rb, ef, eb, flipped, out[1]).numel() > 0


def _tracker_inputs(two_vowels, kind):
    rf, rb = (x.double() for x in two_vowels)
    if kind == "zero_span":
        z = torch.zeros((60, rf.shape[1]), dtype=rf.dtype)
        return torch.cat([rf[:100], z, rf[100:200]]), torch.cat([rb[:100], z, rb[100:200]])
    rf, rb = rf[:200].clone(), rb[:200].clone()
    rf[80, 3:] = float("nan")
    rf[81] = float("nan")
    return rf, rb


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["zero_span", "nan_row"])
def test_plain_scan_equals_voxtpu_on_zero_span_and_nan_row(two_vowels, kind, dt):
    rf, rb = (x.to(dt) for x in _tracker_inputs(two_vowels, kind))
    ef, eb = _seed(dt)
    jf, jb = jax_tracker(*(jnp.asarray(x.numpy()) for x in (rf, rb, ef, eb)), backend="jnp")
    tf, tb = fs.formant_scan_plain(rf, rb, ef, eb)
    np.testing.assert_array_equal(_bits(tf).numpy(), np.asarray(jf).view(_bits(tf).numpy().dtype))
    np.testing.assert_array_equal(_bits(tb).numpy(), np.asarray(jb).view(_bits(tb).numpy().dtype))
