"""The port's Viterbi, batch, long and stream entry points against voxtpu on
the CPU, and the rule that entry points run on the card by default.

Input: tests/fixtures/down_sampled.wav (two vowels at 11025 Hz, 121 frames
of 512, a power-of-two frame, so the shared transform is kernel E's plain
version) with the Viterbi path search on, and three recordings cut from it
at different lengths and gains for the batch entry points. Tolerances per
key are tests/test_torch_pipeline.py's (rms 1e-12, mfcc 1e-9, pitch rtol
1e-5 or 5e-3 on the integer-snap knife edge, formants 1e-7 / 1e-5, status
exact). One more tolerance: candidate lanes whose strength is under 0.1 on
both sides are left out of the pitch_candidates_* comparison. They are
noise-floor maxima of near-silent frames, where ~1e-13 input differences
flip which of two near-tied maxima Brent ends on (PARITY.md deviation 7);
a flip reorders the weak tail of the strength sort (frame 1 here). The
strong lanes, and f0 / strength / HNR along the path, are compared whole.
The chunked and streamed analyses are held to the one-shot `analyze` at
the same tolerances, since each chunk is a batch of another size.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import __graft_entry__ as graft
from voxtpu import pipeline as jp
from voxtpu.formants import formant_tracker_batched as jax_tracker_batched
from voxtpu.io_wav import read_wav

from test_torch_pipeline import KEYS, _assert_key
from voxtpu_torch import pipeline as tp
from voxtpu_torch.device import NoCudaDevice
from voxtpu_torch.formants import formant_tracker_batched
from voxtpu_torch.pipeline import config_from_jax

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SR = 11025.0
JCFG = jp.AnalysisConfig(
    sample_rate=SR, frame_len=512, hop=256,
    pitch=jp.PitchConfig(fmin=60.0, fmax=500.0, max_candidates=16, viterbi=True),
    formant=jp.FormantConfig(n_coeffs=10),
)
CFG = config_from_jax(JCFG)
NO_PATH = dataclasses.replace(CFG, pitch=dataclasses.replace(CFG.pitch, viterbi=False))
LENGTHS = (31232, 20000, 12345)
GAINS = (1.0, 0.5, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(key, got, want, weak_below=0.1):
    """_assert_key, with weak candidate lanes (strength < weak_below on both
    sides) left out of the pitch_candidates_* keys."""
    if key.startswith("pitch_candidates"):
        weak = (got["pitch_candidates_strength"] < weak_below) & (want["pitch_candidates_strength"] < weak_below)
        got = {key: np.where(weak, 0, got[key])}
        want = {key: np.where(weak, 0, want[key]), "pitch_candidates_freq": np.where(weak, 0, want["pitch_candidates_freq"])}
    _assert_key(key, got, want, SR)


@pytest.fixture(scope="module")
def signal():
    return read_wav(os.path.join(FIX, "down_sampled.wav")).samples


@pytest.fixture(scope="module")
def block(signal):
    S = np.zeros((len(LENGTHS), max(LENGTHS)))
    for b, (n, g) in enumerate(zip(LENGTHS, GAINS)):
        S[b, :n] = g * signal[:n]
    return S


@pytest.fixture(scope="module")
def one_shot(signal):
    return {k: v.numpy() for k, v in tp.analyze(torch.as_tensor(signal), CFG).items()}


@pytest.fixture(scope="module")
def one_shot_no_path(signal):
    return {k: v.numpy() for k, v in tp.analyze(torch.as_tensor(signal), NO_PATH).items()}


@pytest.fixture(scope="module")
def viterbi_pair(signal, one_shot):
    want = {k: np.asarray(v) for k, v in jp.analyze(jnp.asarray(signal), JCFG).items()}
    return one_shot, want


@pytest.fixture(scope="module")
def padded_pair(block):
    got = {k: v.numpy() for k, v in tp.analyze_batch_padded(block, LENGTHS, CFG, device="cpu").items()}
    want = {k: np.asarray(v) for k, v in
            jp.analyze_batch_padded(jnp.asarray(block), jnp.asarray(LENGTHS, jnp.int32), JCFG).items()}
    return got, want


@pytest.mark.parametrize("key", KEYS)
def test_viterbi_analyze_matches_jax(viterbi_pair, key):
    got, want = viterbi_pair
    _check(key, got, want)


def test_viterbi_analyze_is_healthy(viterbi_pair):
    got, _ = viterbi_pair
    voiced = got["f0"] > 0
    assert got["f0"].shape == (121,) and voiced.sum() >= 90
    assert 90.0 < np.median(got["f0"][voiced]) < 115.0
    assert not got["status"].any()
    assert np.array_equal(np.isfinite(got["hnr_db"]), voiced)


@pytest.mark.parametrize("key", KEYS)
def test_analyze_batch_padded_matches_jax(padded_pair, key):
    got, want = padded_pair
    assert got[key].shape[:2] == (3, 121)
    flat = lambda d: {k: v.reshape((363,) + v.shape[2:]) for k, v in d.items()}
    _check(key, flat(got), flat(want))


@pytest.mark.parametrize("b", range(3))
def test_batch_rows_equal_analyze_of_each_file(padded_pair, block, b):
    got, _ = padded_pair
    one = {k: v.numpy() for k, v in tp.analyze(torch.as_tensor(block[b, : LENGTHS[b]]), CFG).items()}
    F = one["f0"].shape[0]
    for key in KEYS:
        _check(key, {k: v[b, :F] for k, v in got.items()}, one)
    # Past a recording's frames the block holds all-zero padding frames:
    # unvoiced, with the unvoiced candidate as their only valid one.
    assert not got["f0"][b, F:].any() and (got["pitch_candidates_valid"][b, F:].sum(-1) == 1).all()


def test_analyze_batch_frames_matches_jax(block):
    """(B, F, n) frames: each recording's own frames, then all-zero frames
    up to F = 60."""
    frames = np.zeros((3, 60, 512))
    for b, n in enumerate(LENGTHS):
        nf = min((n - 512) // 256 + 1, 60)
        frames[b, :nf] = [block[b, i * 256 : i * 256 + 512] for i in range(nf)]
    got = tp.analyze_batch(torch.as_tensor(frames), CFG)
    want = jp.analyze_batch(jnp.asarray(frames), JCFG)
    flat = lambda d: {k: np.asarray(v).reshape((180,) + tuple(v.shape[2:])) for k, v in d.items()}
    g, w = flat({k: v.numpy() for k, v in got.items()}), flat(want)
    for key in KEYS:
        _check(key, g, w)


def test_formant_tracker_batched_matches_jax():
    rng = np.random.default_rng(4)
    rf = np.sort(np.round(rng.uniform(100, 4000, (3, 40, 32)) / 200.0) * 200.0, axis=-1)
    rb = np.round(rng.uniform(10, 300, (3, 40, 32)) / 50.0) * 50.0
    rf[:, :, 6:] = 0.0
    est = np.array([320.0, 1440.0, 2760.0, 3200.0])
    got = formant_tracker_batched(torch.as_tensor(rf), torch.as_tensor(rb), torch.as_tensor(est),
                                  torch.ones(4, dtype=torch.float64))
    want = jax_tracker_batched(jnp.asarray(rf), jnp.asarray(rb), jnp.asarray(est), jnp.ones(4), backend="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("viterbi", [True, False])
def test_analyze_long_matches_analyze(signal, one_shot, one_shot_no_path, viterbi):
    cfg = CFG if viterbi else NO_PATH
    want = one_shot if viterbi else one_shot_no_path
    got = {k: v.numpy() for k, v in tp.analyze_long(signal, cfg, chunk_frames=50, device="cpu").items()}
    assert got.keys() == want.keys()
    for key in KEYS:
        _check(key, got, want)


def test_stream_then_finalize_viterbi_matches_analyze(signal, one_shot, one_shot_no_path):
    blocks = [signal[i : i + 3000] for i in range(0, len(signal), 3000)]
    chunks = list(tp.analyze_stream(blocks, NO_PATH, chunk_frames=32, device="cpu"))
    assert [c["f0"].shape[0] for c in chunks] == [32, 32, 32, 25]
    plain = {k: torch.cat([c[k] for c in chunks]).numpy() for k in chunks[0] if not k.startswith("_")}
    for key in KEYS:
        _check(key, plain, one_shot_no_path)
    full = {k: v.numpy() for k, v in tp.finalize_viterbi(chunks, CFG).items()}
    for key in KEYS:
        _check(key, full, one_shot)


def test_stream_finalize_matches_jax_finalize(signal):
    x = signal[:12000]
    jchunks = list(jp.analyze_stream([x], dataclasses.replace(JCFG, pitch=dataclasses.replace(JCFG.pitch, viterbi=False)),
                                     chunk_frames=16))
    want = {k: np.asarray(v) for k, v in jp.finalize_viterbi(jchunks, JCFG).items()}
    got = {k: v.numpy() for k, v in
           tp.finalize_viterbi(tp.analyze_stream([torch.as_tensor(x)], NO_PATH, chunk_frames=16), CFG).items()}
    for key in KEYS:
        _check(key, got, want)


def test_stream_analyzer_rejects_viterbi():
    with pytest.raises(ValueError, match="finalize_viterbi"):
        tp.StreamAnalyzer(CFG)


ENTRY_POINTS = {
    "analyze": lambda x: tp.analyze(x, NO_PATH),
    "analyze_batch": lambda x: tp.analyze_batch(np.zeros((2, 3, 512)), NO_PATH),
    "analyze_batch_padded": lambda x: tp.analyze_batch_padded(np.stack([x, x]), [len(x), 900], NO_PATH),
    "analyze_long": lambda x: tp.analyze_long(x, NO_PATH, chunk_frames=2),
    "analyze_stream": lambda x: list(tp.analyze_stream([x], NO_PATH)),
    "StreamAnalyzer": lambda x: tp.StreamAnalyzer(NO_PATH).feed(x.tolist()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_numpy_input_goes_to_the_card(name):
    """Without device=, a NumPy array (or a list) runs on the card: with no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the input would run there")
    with pytest.raises(NoCudaDevice, match="device='cpu'"):
        ENTRY_POINTS[name](np.zeros(2000))


def test_device_cpu_equals_a_cpu_tensor(signal):
    x = signal[:6000]
    a = tp.analyze(x, CFG, device="cpu")
    b = tp.analyze(torch.as_tensor(x), CFG)
    for key in a:
        assert a[key].device.type == "cpu" and torch.equal(a[key], b[key]), key
    c = tp.analyze(torch.as_tensor(x), CFG, device="cpu")
    assert all(torch.equal(c[k], b[k]) for k in b)


def test_bench_and_flagship_configs_match_jax():
    bench = jp.AnalysisConfig(  # bench.py:49-56
        sample_rate=44100.0, frame_len=4096, hop=1024,
        pitch=jp.PitchConfig(threshold=0.2, fmin=60.0, fmax=600.0, max_candidates=32),
        formant=jp.FormantConfig(n_coeffs=13),
        mfcc=jp.MfccConfig(num_coeffs=13, freq_lo=100.0, freq_hi=8000.0),
    )
    assert config_from_jax(bench) == tp.BENCH_44K
    assert config_from_jax(graft.FLAGSHIP) == tp.FLAGSHIP_44K
