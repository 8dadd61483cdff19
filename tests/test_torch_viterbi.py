"""voxtpu_torch.viterbi and kernel F's plain version against voxtpu on the CPU.

The inputs are the tie-forcing cases of tests/test_pallas.py:274-300:
strengths quantised to 0.1 so that scores tie and the first-win argmax
decides, 30% unvoiced candidates, 10% invalid lanes, frame counts from 1 to
517. Paths are compared bit for bit in float64, with and without the
silence-aware intensity, against voxtpu's lax.scan DP ("jnp") and its
Pallas kernel in interpret mode: the port's f0 and strength along the path
must equal voxtpu's exactly.

Kernel F (csrc/viterbi.cu) runs on the card only; here its pre-pass's
plain form (`transition_costs_plain`) is held bit for bit to the costs the
plain DP forms at each step (random, NaN, -inf, all-unvoiced and
alternating rows, both dtypes), a model of its chain's argmax split (G lanes
a candidate, chunks of 16 items a lane reduced as tournaments, then
shuffles) to torch.max's
first-win index and value bits, its launch rule (`launch_config`) to
csrc/viterbi.cu's constants and its bank, warp, stage and scratch
properties for every C, and its chunks of frame steps (the bounded
scratch) to the one-pass DP.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voxtpu.viterbi as jv

from voxtpu_torch import viterbi
from voxtpu_torch.device import NoCudaDevice
from voxtpu_torch.ops import viterbi as vop

CASES = [(1, 4), (7, 4), (128, 16), (300, 33), (517, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _candidates(F, C, seed=11):
    rng = np.random.default_rng(seed + F * C)
    freq = np.where(rng.random((F, C)) < 0.3, 0.0, rng.uniform(60.0, 600.0, (F, C)))
    strength = np.round(rng.uniform(0.0, 1.0, (F, C)), 1)
    valid = rng.random((F, C)) < 0.9
    valid[:, 0] = True
    li = rng.uniform(0.0, 1.0, F)
    return freq, strength, valid, li


@pytest.mark.parametrize("F, C", CASES)
@pytest.mark.parametrize("with_li", [False, True])
@pytest.mark.parametrize("jax_backend", ["jnp", "pallas_interpret"])
def test_pitch_path_matches_jax(F, C, with_li, jax_backend):
    freq, strength, valid, li = _candidates(F, C)
    kw = {"local_intensity": li} if with_li else {}
    got = viterbi.pitch_path(torch.as_tensor(freq), torch.as_tensor(strength), torch.as_tensor(valid),
                             viterbi.PathConfig(), **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = jv.pitch_path(jnp.asarray(freq), jnp.asarray(strength), jnp.asarray(valid), jv.PathConfig(),
                         backend=jax_backend, **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("F, C", CASES)
def test_pitch_path_host_matches_jax(F, C):
    freq, strength, valid, li = _candidates(F, C, seed=3)
    for kw in ({}, {"local_intensity": li}):
        got = viterbi.pitch_path_host(freq, strength, valid, viterbi.PathConfig(ceiling=500.0), **kw)
        want = jv.pitch_path_host(freq, strength, valid, jv.PathConfig(ceiling=500.0), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("F, C", CASES[1:])
def test_pitch_path_host_matches_pitch_path(F, C):
    freq, strength, valid, li = _candidates(F, C, seed=5)
    host = viterbi.pitch_path_host(freq, strength, valid, local_intensity=li)
    dev = viterbi.pitch_path(torch.as_tensor(freq), torch.as_tensor(strength), torch.as_tensor(valid),
                             local_intensity=torch.as_tensor(li))
    np.testing.assert_array_equal(dev[0].numpy(), host[0])
    np.testing.assert_array_equal(dev[1].numpy(), host[1])


def test_batched_plain_dp_equals_per_recording_calls():
    """(B, F, C) in one call == B calls of (F, C): recordings never mix."""
    B, F, C = 4, 150, 33
    rng = np.random.default_rng(2)
    local = torch.as_tensor(np.where(rng.random((B, F, C)) < 0.1, -np.inf, np.round(rng.uniform(0, 1, (B, F, C)), 1)))
    freq = torch.as_tensor(np.where(rng.random((B, F, C)) < 0.3, 1.0, rng.uniform(60.0, 600.0, (B, F, C))))
    voiced = freq != 1.0
    batched = vop.viterbi_path_plain(local, freq, voiced, 0.35, 0.14)
    assert batched.shape == (B, F) and batched.dtype == torch.int32
    for b in range(B):
        assert torch.equal(batched[b], vop.viterbi_path_plain(local[b], freq[b], voiced[b], 0.35, 0.14))
    assert torch.equal(batched, vop.viterbi_path(local, freq, voiced, 0.35, 0.14))


def test_batched_pitch_path_equals_per_recording():
    cands = [_candidates(200, 33, seed=s) for s in range(3)]
    stack = [torch.as_tensor(np.stack([c[i] for c in cands])) for i in range(4)]
    f0, s0 = viterbi.pitch_path(*stack[:3], local_intensity=stack[3])
    for b, (freq, strength, valid, li) in enumerate(cands):
        want = jv.pitch_path(jnp.asarray(freq), jnp.asarray(strength), jnp.asarray(valid),
                             local_intensity=jnp.asarray(li), backend="jnp")
        np.testing.assert_array_equal(f0[b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(s0[b].numpy(), np.asarray(want[1]))


def test_all_invalid_lanes_resolve_to_candidate_zero():
    """Every total -inf: argmax gives 0 in the DP and at the path start, as
    jnp.argmax does."""
    F, C = 6, 5
    local = torch.full((F, C), -np.inf, dtype=torch.float64)
    freq = torch.ones((F, C), dtype=torch.float64)
    path = vop.viterbi_path_plain(local, freq, freq > 1.0, 0.35, 0.14)
    assert torch.equal(path, torch.zeros(F, dtype=torch.int32))


def test_path_config_and_take_best_match_jax():
    assert vars(viterbi.PathConfig()) == vars(jv.PathConfig())
    freq, strength, _, _ = _candidates(9, 4)
    got = viterbi.take_best(torch.as_tensor(freq), torch.as_tensor(strength))
    want = jv.take_best(jnp.asarray(freq), jnp.asarray(strength))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("use_path", [True, False])
def test_pitch_track_matches_jax(use_path):
    """Candidates + path on windowed noisy sine frames; f0 within the pitch
    suite's rtol 1e-5 (Brent's candidates agree to that), the path choice
    exact."""
    rng = np.random.default_rng(8)
    t = np.arange(40 * 256 + 512) / 11025.0
    x = np.sin(2 * np.pi * 140.0 * t * (1 + 0.2 * t)) + 0.3 * rng.standard_normal(t.shape)
    frames = np.stack([x[i * 256 : i * 256 + 512] for i in range(40)]) * np.hanning(512)
    got = viterbi.pitch_track(frames, 11025.0, fmax=500.0, max_candidates=8, use_path=use_path, device="cpu")
    want = jv.pitch_track(jnp.asarray(frames), 11025.0, fmax=500.0, max_candidates=8, use_path=use_path)
    np.testing.assert_array_equal(got[0].numpy() > 0, np.asarray(want[0]) > 0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-8)


def test_pitch_track_numpy_input_goes_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the input would run there")
    with pytest.raises(NoCudaDevice, match="device='cpu'"):
        viterbi.pitch_track(np.zeros((3, 512)), 11025.0)


# ---- kernel F's pre-pass, argmax split and launch rule (csrc/viterbi.cu)

CU = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc" / "viterbi.cu"
DTYPES = [torch.float32, torch.float64]


def _dp_inputs(B, F, C, dt, seed=0, case="random"):
    """(local, freq, voiced) as `path_inputs` builds them: freq 1.0 where a
    candidate is unvoiced, strengths quantised to 0.1 so that totals tie."""
    rng = np.random.default_rng(seed)
    voiced = rng.random((B, F, C)) < 0.7
    if case == "all unvoiced":
        voiced[:] = False
    if case == "alternating":
        voiced = np.broadcast_to((np.arange(F) % 2 == 0)[None, :, None], (B, F, C)).copy()
    freq = np.where(voiced, rng.uniform(60.0, 600.0, (B, F, C)), 1.0)
    local = np.round(rng.uniform(0.0, 1.0, (B, F, C)), 1)
    local[rng.random((B, F, C)) < 0.1] = -np.inf
    if case == "NaN":
        local[:, F // 2, 1] = np.nan
        freq[:, 1, 2] = np.nan
        voiced[:, 1, 2] = True
    if case == "-inf":
        local[:, 1:3] = -np.inf
    return (torch.as_tensor(local, dtype=dt), torch.as_tensor(freq, dtype=dt), torch.as_tensor(voiced))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["random", "NaN", "-inf", "all unvoiced", "alternating"])
def test_transition_costs_plain_equal_the_dp_costs(case, dt):
    """The pre-pass's plain form, every step at once, gives bit for bit the
    costs `viterbi_path_plain` forms at each step (as the DP forms them
    there, recomputed here)."""
    local, freq, voiced = _dp_inputs(3, 40, 33, dt, case=case)
    ojc, vuc = 0.35, 0.14
    got = vop.transition_costs_plain(freq, voiced, ojc, vuc)
    assert got.shape == (3, 39, 33, 33) and got.dtype == dt
    vuc_t, zero = torch.tensor(vuc, dtype=dt), torch.zeros((), dtype=dt)
    for t in range(1, 40):
        vp, vc = voiced[:, t - 1, :, None], voiced[:, t, None, :]
        jump = torch.abs(torch.log2(freq[:, t - 1, :, None] / freq[:, t, None, :]))
        want = torch.where(vp & vc, ojc * jump, torch.where(vp ^ vc, vuc_t, zero))
        assert torch.equal(_bits(got[:, t - 1]), _bits(want)), t
    if case == "all unvoiced":
        assert not got.any()


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def _later(b, ib, a, ia):
    """csrc/viterbi.cu later: (b, ib), after (a, ia) in index, wins by a
    larger value or as a NaN over a number."""
    return (b, ib) if b > a or (np.isnan(b) and not np.isnan(a)) else (a, ia)


def _model_chain_argmax(totals: np.ndarray, G: int, chunk: int = 16):
    """viterbi_chain's argmax over one column of C totals: lane g of the G
    lanes takes the run of items k = 0, 1, ... (i = g L + k, L = ceil(C /
    G); a lane past the last candidate starts at -inf and has none); item 0
    starts its argmax, then each chunk of 16 items (past the run -inf) is
    reduced as a tournament over adjacent pairs and joined after; the
    group's lanes combine by shuffles down (off = 1, 2, ..., G / 2, so that
    lane g + off holds the runs after lane g's; a lane whose partner lies
    past the group keeps its own). Every join is of
    index-ordered pairs (`_later`). Returns lane 0's (value, index)."""
    C = len(totals)
    L = -(-C // G)
    ninf = totals.dtype.type(-np.inf)
    lanes = []
    for g in range(G):
        items = min(L, C - g * L)
        best = (totals[g * L], g * L) if items > 0 else (ninf, g * L)
        for k0 in range(1, items, chunk):
            pairs = [(totals[g * L + k], g * L + k) if k < items else (ninf, g * L + k) for k in range(k0, k0 + chunk)]
            w = 1
            while w < chunk:
                for c in range(0, chunk, 2 * w):
                    pairs[c] = _later(*pairs[c + w], *pairs[c])
                w *= 2
            best = _later(*pairs[0], *best)
        lanes.append(best)
    off = 1
    while off < G:
        lanes = [_later(*lanes[l + off], *lanes[l]) if l + off < G else lanes[l] for l in range(G)]
        off *= 2
    return lanes[0]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 32, 33, 64, 65, 128])
def test_chain_argmax_split_is_first_win(C, dt):
    """Every split of i the kernel makes finds torch.max's first-win index
    and its value's bits: ties, NaNs (the first NaN wins), all -inf (index
    0) and -0.0 against +0.0."""
    G = vop.launch_config(1, 2, C, torch.float32 if dt == np.float32 else torch.float64).lanes
    rng = np.random.default_rng(C)
    rows = [np.round(rng.uniform(-1, 1, C), 1).astype(dt) for _ in range(40)]
    rows.append(np.full(C, -np.inf, dt))
    rows.append(np.where(np.arange(C) % 3 == 1, np.nan, 0.5).astype(dt))
    rows.append(np.where(np.arange(C) % 2 == 0, -0.0, 0.0).astype(dt))
    rows.append(np.where(np.arange(C) >= C // 2, np.nan, -np.inf).astype(dt))
    for row in rows:
        value, index = _model_chain_argmax(row, G)
        want_v, want_i = torch.max(torch.as_tensor(row), dim=0)
        assert index == int(want_i), (row, index, int(want_i))
        assert np.asarray(value).tobytes() == row[int(want_i)].tobytes()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


def test_launch_config_mirrors_the_cuda_source():
    assert vop._MAX_C == _cu_const("kMaxC")
    assert vop._CHAIN_THREADS == _cu_const("kChainThreads")
    assert vop._MAX_STAGES == _cu_const("kMaxStages")
    assert vop._SMEM_LIMIT == _cu_const("kSmemLimit")
    src = CU.read_text()
    for line in ("while (c.lanes > C || c.lanes * C > kChainThreads) c.lanes >>= 1;",
                 "c.run = (C + c.lanes - 1) / c.lanes;",
                 "c.pitch = (c.run - 1 + kChunk - 1) / kChunk * kChunk + 1;",
                 "c.record = round_up((C * c.lanes * c.pitch + C) * isz, 16);",
                 "const int fixed = round_up(2 * kScores * isz, 16) + 2 * kMaxStages * 8 + 16;",
                 "c.per = fit >= 4 ? 2 : 1;", "c.smem = c.stages * c.per * c.record + fixed;",
                 "constexpr int kScores = kMaxC + 32;"):
        assert line in src
    assert vop._SCORES == vop._MAX_C + 32 and vop._CHUNK == _cu_const("kChunk")


@pytest.mark.parametrize("dt", DTYPES)
def test_launch_config_is_a_pure_rule(dt):
    """For every C: G a power of two with G <= C and G C <= 128 (the most
    such), the chain's whole warps (at most 4), runs of L = ceil(C / G) at
    a pitch P that holds every 16-item chunk a lane reads (1 + 16 ceil((L -
    1) / 16)) and is odd, so that a warp's 32 lanes, lane (j, g) reading row
    j's run g at (j G + g) P + k, read 32 distinct banks, a score row's
    G P slots within its 160, records of whole 16 bytes, 1 to 8 stages of
    1 or 2 records (2 where two stages of two fit) within the block's
    shared memory, and the scratch of B (F - 1) records (one chunk here)."""
    isz = dt.itemsize
    for C in range(1, 129):
        c = vop.launch_config(3, 50, C, dt)
        assert c == vop.launch_config(3, 50, C, dt)
        G = c.lanes
        assert G & (G - 1) == 0 and G <= C and G * C <= 128 and (2 * G > C or 2 * G * C > 128)
        assert c.chain == -(-G * C // 32) * 32 <= 128
        assert c.run == -(-C // G) and c.pitch % 2 == 1 and c.pitch >= c.run
        assert all(k0 + 15 < c.pitch for k0 in range(1, c.run, 16)) and G * c.pitch <= vop._SCORES
        assert all(len({(lane * c.pitch + k) % 32 for lane in range(32)}) == 32 for k in range(c.run))
        assert c.record % 16 == 0 and c.record >= (C * G * c.pitch + C) * isz
        assert 1 <= c.stages <= 8 and c.per in (1, 2) and c.smem <= vop._SMEM_LIMIT
        assert c.per == 1 or c.stages >= 2
        assert c.scratch == 3 * 49 * c.record
    c33 = vop.launch_config(1, 15369, 33, dt)
    assert (c33.lanes, c33.chain, c33.run, c33.pitch, c33.per, c33.stages) == (2, 96, 17, 17, 2, 8)
    assert vop.launch_config(1, 9, 128, torch.float64).stages == 1  # one record: the chain releases, then waits
    assert c33.record == (4624 if dt == torch.float32 else 9248)
    assert vop.launch_config(2, 1, 33, dt).scratch == 0
    for bad in ((1, 5, 0), (1, 5, 129), (1, 0, 5)):
        with pytest.raises(ValueError):
            vop.launch_config(*bad, dt)
    with pytest.raises(TypeError):
        vop.launch_config(1, 5, 5, torch.float16)


def test_wrapper_counts_clocks_on_the_card_only():
    """The chain's clock probe and the chunk choice are reached through the
    private launcher, which takes CUDA tensors only: viterbi_path's
    signature is the plain version's."""
    local, freq, voiced = _dp_inputs(1, 5, 4, torch.float64)
    with pytest.raises(ValueError, match="card only"):
        vop._launch(local, freq, voiced, 0.35, 0.14, stamps=torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError):
        vop.viterbi_path(local, freq, voiced, 0.35, 0.14, clocks=torch.zeros(8, dtype=torch.int64))


def _host_chunks(F, steps):
    """The (t0, t1) frame-step ranges of csrc/viterbi.cu's host loop."""
    out, t0 = [], 1
    while True:
        t1 = F if F - t0 < steps else t0 + steps
        out.append((t0, t1))
        if t1 == F:
            return out
        t0 += steps


@pytest.mark.parametrize("dt", DTYPES)
def test_launch_config_bounds_the_scratch(dt):
    """Chunks of frame steps keep the records within 16 MiB, or 64 records
    a recording where 16 MiB holds fewer, at any length: 3,628 steps a
    chunk (float32; 1,814 float64) at the bench path's 33 candidates, 226
    (113) for the 16-recording corpus block, 64 at 16 recordings of C = 128
    in float64; the host loop's chunks tile the steps 1 .. F - 1."""
    for B, F, C in ((1, 15369, 33), (1, 30741, 33), (16, 972, 33), (16, 600_000, 128), (4096, 20, 128),
                    (2, 1, 33), (3, 50, 5)):
        c = vop.launch_config(B, F, C, dt)
        assert c.scratch == B * c.steps * c.record
        assert c.scratch <= max(vop._SCRATCH_LIMIT, vop._MIN_STEPS * B * c.record)
        assert c.steps == (0 if F == 1 else min(F - 1, max(64, vop._SCRATCH_LIMIT // (B * c.record))))
        chunks = _host_chunks(F, c.steps)
        assert chunks[0][0] == 1 and chunks[-1][1] == F
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(0 < t1 - t0 <= c.steps for t0, t1 in chunks) or F == 1
        assert len(chunks) == vop._chunks(F, c.steps)
    f32 = dt == torch.float32
    assert vop.launch_config(1, 15369, 33, dt).steps == (3628 if f32 else 1814)
    assert vop.launch_config(16, 972, 33, dt).steps == (226 if f32 else 113)
    assert vop.launch_config(16, 600_000, 128, torch.float64).steps == 64
    assert vop._SCRATCH_LIMIT == 16 << 20 and vop._MIN_STEPS == 64


@pytest.mark.parametrize("steps", [1, 2, 7, 16, 39])
def test_chunks_carrying_scores_equal_one_pass(steps):
    """The DP run chunk by chunk as the host loop splits it, each chunk
    starting from the scores the one before left (the kernel's carry), gives
    the one-pass plain path bit for bit: the chunks change no operation."""
    local, freq, voiced = _dp_inputs(3, 40, 7, torch.float64)
    B, F, C = local.shape
    costs = vop.transition_costs_plain(freq, voiced, 0.35, 0.14)
    score, bps = local[:, 0], []
    for t0, t1 in _host_chunks(F, steps):
        for t in range(t0, t1):
            best, arg = torch.max(score[:, :, None] - costs[:, t - 1], dim=1)
            bps.append(arg)
            score = local[:, t] + best
    c = torch.argmax(score, dim=-1)
    path = [c]
    for arg in reversed(bps):
        c = torch.gather(arg, 1, c[:, None])[:, 0]
        path.append(c)
    got = torch.stack(path[::-1], dim=1).to(torch.int32)
    assert torch.equal(got, vop.viterbi_path_plain(local, freq, voiced, 0.35, 0.14))
