"""voxtpu_torch basics against voxtpu on the CPU, plus the port's guards.

Inputs come from numpy (seeded) or the fixtures, in float64. The JAX side
runs as the rest of the suite runs it (CPU, x64). Framing, windows, waves,
autocorrelation and MFCC agree to <= 1e-10; the guards pin that the port
never imports JAX, that a missing nvcc raises instead of falling back to
the plain versions, and that CPU runs launch no kernel.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voxtpu.autocorr as jac
import voxtpu.cplx as jcplx
import voxtpu.frame as jframe
import voxtpu.io_wav as jio
import voxtpu.waves as jwaves
import voxtpu.windows as jwin
from voxtpu.cli import build_analysis_config
from voxtpu.mfcc import dct_matrix as jax_dct_matrix
from voxtpu.mfcc import mel_banks as jax_mel_banks
from voxtpu.mfcc import mfcc as jax_mfcc
from voxtpu.pipeline import AnalysisConfig as JaxAnalysisConfig
from voxtpu.pipeline import FormantConfig as JaxFormantConfig
from voxtpu.pipeline import MfccConfig as JaxMfccConfig
from voxtpu.pipeline import PitchConfig as JaxPitchConfig

from voxtpu_torch import autocorr, cplx, frame, io_wav, mfcc, waves, windows
from voxtpu_torch.ops import burg, find_roots, formant_scan, kernels, refine
from voxtpu_torch.pipeline import CLI_DEFAULT_44K, analyze, config_from_jax

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-10, atol=1e-10)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- guards


def test_port_imports_no_jax_and_no_voxtpu():
    code = (
        "import importlib, pkgutil, sys, voxtpu_torch\n"
        "for m in pkgutil.walk_packages(voxtpu_torch.__path__, 'voxtpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'voxtpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('voxtpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module was imported


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "library_path", lambda: tmp_path / "libmissing.so")
    kernels.library.cache_clear()
    try:
        with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
            kernels.library()
        # A wrapper handed a tensor it would launch on raises the same way:
        # it never answers with its plain version.
        monkeypatch.setattr(kernels, "on_cpu", lambda *t: False)
        x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 64)))
        with pytest.raises(kernels.KernelBuildError):
            burg.burg(x, 4)
        assert burg.burg.launches == 0
    finally:
        kernels.library.cache_clear()


def test_wrappers_reject_non_cuda_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        burg.burg(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.on_cpu(torch.zeros(2), x)


def test_cpu_analyze_launches_no_kernel():
    rng = np.random.default_rng(5)
    sig = torch.as_tensor(rng.standard_normal(6000))
    cfg = config_from_jax(
        JaxAnalysisConfig(8000.0, 512, 256, JaxPitchConfig(fmax=500.0), JaxFormantConfig(n_coeffs=8))
    )
    out = analyze(sig, cfg)
    frames = (6000 - 512) // 256 + 1
    assert out["f0"].shape == (frames,) and out["mfcc"].shape == (frames, 13)
    for op in (refine.refine, burg.burg, find_roots.find_roots, formant_scan.formant_scan):
        assert op.launches == 0


# ---------------------------------------------------------------- config + tables


def test_cli_default_config_matches_jax_cli():
    assert config_from_jax(build_analysis_config(44100.0)) == CLI_DEFAULT_44K
    assert (CLI_DEFAULT_44K.frame_len, CLI_DEFAULT_44K.hop) == (2205, 441)


def test_config_from_jax_reads_every_field():
    jcfg = JaxAnalysisConfig(
        16000.0, 800, 160,
        JaxPitchConfig(enabled=False, threshold=0.3, fmin=70.0, fmax=450.0, max_candidates=12,
                       refine="parabolic", refine_depth=70),
        JaxFormantConfig(n_coeffs=10, resample_ratio=0.5, estimates=(480.0, 1760.0, 3200.0, 3520.0),
                         estimate_bandwidth=2.0, polish=False),
        JaxMfccConfig(num_coeffs=20, freq_lo=50.0, freq_hi=4000.0, preemphasis_factor=0.01, exact=False),
    )
    cfg = config_from_jax(jcfg)
    for sec in ("pitch", "formant", "mfcc"):
        for k, v in vars(getattr(jcfg, sec)).items():
            assert getattr(getattr(cfg, sec), k) == v, (sec, k)
    assert (cfg.sample_rate, cfg.frame_len, cfg.hop) == (16000.0, 800, 160)


@pytest.mark.parametrize("n", [512, 800, 2205])
def test_window_tables_equal(n):
    np.testing.assert_array_equal(windows.hann(n), jwin.hann(n))
    np.testing.assert_array_equal(windows.hanning_lag(n), jwin.hanning_lag(n))


@pytest.mark.parametrize("n, sr, lo, hi, exact", [
    (2205, 44100.0, 100.0, 5000.0, True), (512, 11025.0, 100.0, 5000.0, True), (800, 16000.0, 50.0, 6000.0, False),
])
def test_mel_and_dct_tables_equal(n, sr, lo, hi, exact):
    for a, b in zip(mfcc.mel_banks(n, 13, lo, hi, sr, exact), jax_mel_banks(n, 13, lo, hi, sr, exact)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mfcc.dct_matrix(13), jax_dct_matrix(13))


# ---------------------------------------------------------------- signal basics


@pytest.mark.parametrize("frame_len, hop, window", [
    (2205, 441, "rectangle"), (512, 256, "rectangle"), (512, 256, "hanning"), (100, 37, "rectangle"),
])
def test_frame_signal_matches_jax(frame_len, hop, window):
    x = np.random.default_rng(1).standard_normal(9000)
    got = frame.frame_signal(torch.as_tensor(x), frame_len, hop, window=window)
    want = jframe.frame_signal(jnp.asarray(x), frame_len, hop, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert frame.num_frames(9000, frame_len, hop) == jframe.num_frames(9000, frame_len, hop) == got.shape[0]


def test_frame_signal_too_short_raises():
    with pytest.raises(ValueError, match="too short"):
        frame.frame_signal(torch.zeros(10), 20, 5)


def test_waves_match_jax():
    x = np.random.default_rng(2).standard_normal((4, 300))
    t, j = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(_np(waves.rms(t)), np.asarray(jwaves.rms(j)), **TOL)
    np.testing.assert_allclose(_np(waves.amplitude(t)), np.asarray(jwaves.amplitude(j)), **TOL)
    np.testing.assert_allclose(_np(waves.max_amplitude(t)), np.asarray(jwaves.max_amplitude(j)), **TOL)
    np.testing.assert_allclose(_np(waves.normalize(t)), np.asarray(jwaves.normalize(j)), **TOL)
    np.testing.assert_allclose(
        _np(waves.preemphasis(t, 0.05)), np.asarray(jwaves.preemphasis(j, 0.05)), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("n", [2205, 512, 37])
@pytest.mark.parametrize("quirk", [True, False])
def test_autocorrelate_matches_jax(n, quirk):
    x = np.random.default_rng(n).standard_normal((3, n))
    got = autocorr.autocorrelate(torch.as_tensor(x), quirk=quirk)
    want = jac.autocorrelate(jnp.asarray(x), quirk=quirk, backend="fft")
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got = autocorr.autocorrelate(torch.as_tensor(x), n_coeffs=n // 3, quirk=quirk)
    want = jac.autocorrelate(jnp.asarray(x), n_coeffs=n // 3, quirk=quirk, backend="fft")
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [2205, 512])
def test_power_and_autocorrelate_matches_jax(n):
    x = np.random.default_rng(n + 1).standard_normal((3, n))
    hp, ac = autocorr.power_and_autocorrelate(torch.as_tensor(x))
    jhp, jac_ = jac.power_and_autocorrelate(jnp.asarray(x), backend="fft")
    np.testing.assert_allclose(_np(hp), np.asarray(jhp), **TOL)
    np.testing.assert_allclose(_np(ac), np.asarray(jac_), **TOL)


def test_autocorr_other_backends_not_ported():
    x = torch.zeros((1, 256))
    for backend in ("ct", "ct_fused"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            autocorr.autocorrelate(x, backend=backend)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            autocorr.power_and_autocorrelate(x, backend=backend)


@pytest.mark.parametrize("n, sr, exact", [(2205, 44100.0, True), (512, 11025.0, True), (800, 16000.0, False)])
def test_mfcc_matches_jax(n, sr, exact):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)) * jwin.hann(n)
    got = mfcc.mfcc(torch.as_tensor(x), 13, (100.0, 5000.0), sr, exact=exact)
    want = jax_mfcc(jnp.asarray(x), 13, (100.0, 5000.0), sr, exact=exact)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_mfcc_half_power_input_matches_jax():
    x = np.random.default_rng(9).standard_normal((4, 512)) * jwin.hann(512)
    hp = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    got = mfcc.mfcc(torch.as_tensor(x), 13, (100.0, 5000.0), 11025.0, half_power=torch.as_tensor(hp))
    want = jax_mfcc(jnp.asarray(x), 13, (100.0, 5000.0), 11025.0, half_power=jnp.asarray(hp))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_cplx_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 50))
    b = rng.standard_normal((2, 50))
    ta, tb = cplx.C(torch.as_tensor(a[0]), torch.as_tensor(a[1])), cplx.C(torch.as_tensor(b[0]), torch.as_tensor(b[1]))
    ja, jb = jcplx.C(jnp.asarray(a[0]), jnp.asarray(a[1])), jcplx.C(jnp.asarray(b[0]), jnp.asarray(b[1]))
    for name in ("cmul", "cdiv", "cadd", "csub"):
        got, want = getattr(cplx, name)(ta, tb), getattr(jcplx, name)(ja, jb)
        np.testing.assert_allclose(_np(got.re), np.asarray(want.re), **TOL)
        np.testing.assert_allclose(_np(got.im), np.asarray(want.im), **TOL)
    for name in ("csqrt", "cinv", "cneg", "cconj"):
        got, want = getattr(cplx, name)(ta), getattr(jcplx, name)(ja)
        np.testing.assert_allclose(_np(got.re), np.asarray(want.re), **TOL)
        np.testing.assert_allclose(_np(got.im), np.asarray(want.im), **TOL)


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(FIX) if f.endswith(".wav")))
def test_read_wav_matches_jax(name):
    got = io_wav.read_wav(os.path.join(FIX, name))
    want = jio.read_wav(os.path.join(FIX, name))
    assert (got.sample_rate, got.bits_per_sample) == (want.sample_rate, want.bits_per_sample)
    np.testing.assert_array_equal(got.samples, want.samples)
