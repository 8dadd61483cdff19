"""voxtpu_torch.viterbi and kernel F's plain version against voxtpu on the CPU.

The inputs are the tie-forcing cases of tests/test_pallas.py:274-300:
strengths quantised to 0.1 so that scores tie and the first-win argmax
decides, 30% unvoiced candidates, 10% invalid lanes, frame counts from 1 to
517. Paths are compared bit for bit in float64, with and without the
silence-aware intensity, against voxtpu's lax.scan DP ("jnp") and its
Pallas kernel in interpret mode: the port's f0 and strength along the path
must equal voxtpu's exactly.
"""

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
