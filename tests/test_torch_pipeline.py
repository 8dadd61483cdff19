"""The voxtpu_torch slice as a whole against voxtpu on the CPU.

`voxtpu_torch.pipeline.analyze` and `voxtpu.pipeline.analyze` take the same
float64 samples at `CLI_DEFAULT_44K` (the first 1 s of two-vowels) and at
the verify skill's config (short_sample.wav, 512/256, fmax 500, order 10).
Per-key tolerances:
- rms 1e-12 relative, mfcc 1e-9;
- f0 / f0_strength rtol 1e-5, or 5e-3 where the refined lag sits within
  1e-3 of an integer (the integer-snap knife edge, tests/test_traces_16k.py:64-76);
- formant freqs rtol 1e-7 / atol 1e-5, bws rtol 1e-6 / atol 1e-4
  (tests/test_traces_16k.py:36-41);
- status exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voxtpu import pipeline as jp
from voxtpu.cli import build_analysis_config
from voxtpu.io_wav import read_wav

from voxtpu_torch import errors
from voxtpu_torch.device import NoCudaDevice
from voxtpu_torch.pipeline import (
    CLI_DEFAULT_44K, analyze, analyze_frames, config_from_jax, f0_outputs, f0_outputs_host,
)
from voxtpu_torch.frame import frame_signal

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SKILL_CFG = jp.AnalysisConfig(
    sample_rate=11025.0, frame_len=512, hop=256,
    pitch=jp.PitchConfig(fmin=60.0, fmax=500.0, max_candidates=16),
    formant=jp.FormantConfig(n_coeffs=10),
)
KEYS = ["rms", "mfcc", "f0", "f0_strength", "hnr_db", "formant_freqs", "formant_bws", "status",
        "pitch_candidates_freq", "pitch_candidates_strength", "pitch_candidates_valid"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(samples, jcfg):
    want = {k: np.asarray(v) for k, v in jp.analyze(jnp.asarray(samples), jcfg).items()}
    got = {k: v.numpy() for k, v in analyze(torch.as_tensor(samples), config_from_jax(jcfg)).items()}
    return got, want


@pytest.fixture(scope="module")
def cli_slice():
    wav = read_wav(os.path.join(FIX, "sample-two_vowels.wav"))
    jcfg = build_analysis_config(44100.0)
    assert config_from_jax(jcfg) == CLI_DEFAULT_44K
    return _run_both(wav.samples[:44100], jcfg), 44100.0


@pytest.fixture(scope="module")
def skill_slice():
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    return _run_both(wav.samples, SKILL_CFG), 11025.0


def _knife_rtol(f0, sr, base):
    lag = np.where(f0 > 0, sr / np.where(f0 > 0, f0, 1.0), 0.0)
    return np.where(np.abs(lag - np.round(lag)) < 1e-3, 5e-3, base)


def _assert_key(key, got, want, sr):
    g, w = got[key], want[key]
    assert g.shape == w.shape, (key, g.shape, w.shape)
    if key in ("status", "pitch_candidates_valid"):
        np.testing.assert_array_equal(g, w)
    elif key == "rms":
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    elif key == "mfcc":
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    elif key == "formant_freqs":
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-5)
    elif key == "formant_bws":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)
    else:  # the pitch family
        f0 = want["f0"] if w.ndim == 1 else want["pitch_candidates_freq"]
        rt = _knife_rtol(f0, sr, 1e-5)
        if key == "hnr_db":  # -inf exactly where f0 == 0; dB of the strength
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            fin = np.isfinite(w)
            g, w, rt = g[fin], w[fin], rt[fin] * 100  # d(hnr) ~ ds / (s (1 - s)), s <= 1 - 1e-6
        assert np.all(np.abs(g - w) <= 1e-8 + rt * np.abs(w)), (key, np.abs(g - w).max())


@pytest.mark.parametrize("key", KEYS)
def test_cli_default_slice_matches_jax(cli_slice, key):
    (got, want), sr = cli_slice
    _assert_key(key, got, want, sr)


def test_cli_default_slice_is_healthy(cli_slice):
    (got, _), _ = cli_slice
    assert got["f0"].shape == (96,) and got["formant_freqs"].shape == (96, 4)
    assert not got["status"].any()
    assert (got["f0"] > 0).sum() >= 80


@pytest.mark.parametrize("key", KEYS)
def test_skill_config_matches_jax(skill_slice, key):
    (got, want), sr = skill_slice
    _assert_key(key, got, want, sr)


def test_skill_config_healthy_output(skill_slice):
    """The verify skill's health bar: f0 ~ 99-101.2 Hz on all 10 frames,
    F1 ~ 1000-1050 Hz, status 0."""
    (got, _), _ = skill_slice
    assert got["f0"].shape == (10,)
    assert np.all((got["f0"] > 99.0) & (got["f0"] < 101.2))
    assert np.all((got["formant_freqs"][:, 0] > 1000.0) & (got["formant_freqs"][:, 0] < 1050.0))
    assert not got["status"].any()


def test_all_zero_input_matches_jax():
    got, want = _run_both(np.zeros(3000), SKILL_CFG)
    for key in KEYS:
        _assert_key(key, got, want, 11025.0)
    assert np.all(got["status"] == errors.LPC_DENUM_NONPOS)
    for k, v in got.items():
        if k != "hnr_db" and v.dtype.kind == "f":
            assert np.all(np.isfinite(v)), k
    assert np.all(got["hnr_db"] == -np.inf) and np.all(got["f0"] == 0)


def test_formant_candidates_branch_matches_jax():
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    frames = frame_signal(torch.as_tensor(wav.samples), 512, 256)
    want = jp.analyze_frames(jnp.asarray(frames.numpy()), SKILL_CFG, return_formant_candidates=True)
    got = analyze_frames(frames, config_from_jax(SKILL_CFG), return_formant_candidates=True)
    assert "formant_freqs" not in got and got["resonance_freqs"].shape == (10, 32)
    np.testing.assert_allclose(got["resonance_freqs"].numpy(), np.asarray(want["resonance_freqs"]), rtol=1e-7, atol=1e-5)
    np.testing.assert_allclose(got["resonance_bws"].numpy(), np.asarray(want["resonance_bws"]), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got["status"].numpy(), np.asarray(want["status"]))


def test_formant_estimates_carry_matches_jax():
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    frames = frame_signal(torch.as_tensor(wav.samples), 512, 256)
    est = (np.array([500.0, 1500.0, 2500.0, 3500.0]), np.array([50.0, 80.0, 120.0, 160.0]))
    want = jp.analyze_frames(jnp.asarray(frames.numpy()), SKILL_CFG, formant_estimates=tuple(map(jnp.asarray, est)))
    got = analyze_frames(frames, config_from_jax(SKILL_CFG), formant_estimates=tuple(map(torch.as_tensor, est)))
    np.testing.assert_allclose(got["formant_freqs"].numpy(), np.asarray(want["formant_freqs"]), rtol=1e-7, atol=1e-5)
    np.testing.assert_allclose(got["formant_bws"].numpy(), np.asarray(want["formant_bws"]), rtol=1e-6, atol=1e-4)


def test_fast_mode_f32_within_budget_of_f64():
    """The port in float32 against itself in float64 on the CPU, within
    tests/test_fast_mode.py:62-69's budget for short_sample.wav."""
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    cfg = config_from_jax(SKILL_CFG)
    f64 = analyze(torch.as_tensor(wav.samples), cfg)
    f32 = analyze(torch.as_tensor(wav.samples, dtype=torch.float32), cfg)
    assert all(v.dtype in (torch.float32, torch.bool, torch.int32) for v in f32.values())
    voiced = f64["f0"] > 0
    budgets = {"f0": 0.3, "f0_strength": 8e-3, "formant_freqs": 1.0, "mfcc": 1e-4}
    for key, atol in budgets.items():
        a, b = f32[key].double(), f64[key]
        if key == "f0":
            a, b = a[voiced], b[voiced]
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0, err_msg=key)
    np.testing.assert_allclose(f32["rms"].double().numpy(), f64["rms"].numpy(), rtol=1e-5)
    assert not f32["status"].any()


def test_viterbi_not_yet_ported():
    """PitchConfig.viterbi now runs (kernel F's plain version on the CPU):
    at the skill config with viterbi=True the port's features equal
    voxtpu's, f0 along the path included."""
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    jcfg = dataclasses.replace(SKILL_CFG, pitch=dataclasses.replace(SKILL_CFG.pitch, viterbi=True))
    got, want = _run_both(wav.samples, jcfg)
    for key in KEYS:
        _assert_key(key, got, want, 11025.0)
    assert np.all((got["f0"] > 99.0) & (got["f0"] < 101.2))


def test_numpy_input_runs_on_the_card_unless_device_cpu():
    """An entry point sends a NumPy array to the card: with none it raises.
    device="cpu" gives what a CPU tensor gives."""
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    cfg = config_from_jax(SKILL_CFG)
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            analyze(wav.samples, cfg)
    a = analyze(wav.samples, cfg, device="cpu")
    b = analyze(torch.as_tensor(wav.samples), cfg)
    assert all(a[k].device.type == "cpu" and torch.equal(a[k], b[k]) for k in b)


def test_f0_outputs_host_matches_f0_outputs():
    f0 = np.array([0.0, 120.0, 95.5, 0.0])
    s = np.array([0.2, 0.9, 0.45, 0.999999999])
    a = f0_outputs(torch.as_tensor(f0), torch.as_tensor(s))
    b = f0_outputs_host(f0, s)
    w = jp.f0_outputs(jnp.asarray(f0), jnp.asarray(s))
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k], rtol=1e-12)
        np.testing.assert_allclose(a[k].numpy(), np.asarray(w[k]), rtol=1e-12)
