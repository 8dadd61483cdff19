"""Frames of 8,192 to 32,768 samples: the port against voxtpu on the CPU.

The counterpart of tests/test_large_frames.py. The same inputs, made from a
seed with numpy, go through voxtpu's functions and the port's:
- `analyze_frames` at 8,192 and 16,384 (hop n/4, the configuration of
  tests/test_large_frames.py:34-52), two frames each in float64, every key
  at tests/test_torch_pipeline.py's tolerances, on the noisy frames of
  tests/test_large_frames.py:_noisy_frames; on its pure two-sine frames
  every key but the formants, and voxtpu's f0 check (the true period or an
  integer division of it). Burg on a near-pure long sine is ill-conditioned
  (tests/test_large_frames.py:104-108): there the formants part from
  voxtpu's by up to 4.4 Hz at 16,384 (1.6 Hz at 8,192), as the known pure
  sine spread of ROADMAP.md. On the card those frames take kernel E, over a
  thread-block cluster at 16,384 in float32 and at both lengths in
  float64;
- Burg at 32,768 in both dtypes (kernel B over a thread-block cluster on
  the card): `burg_plain` and `_model_burg`, the kernel's order of
  operations at the launch the rule gives, against `voxtpu.lpc.burg`
  (under jax.jit: eagerly every order slices at a new length and compiles
  its own program);
- the shape gate: for every power of two n from 64 to 65,536, with nfft =
  2n and 4n, in both dtypes, E's `ct_fused_supported` equals voxtpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu import pipeline as jp
from voxtpu.lpc import burg as jax_burg
from voxtpu.ops.ct_fused_pallas import ct_fused_supported as jax_ct_fused_supported

from test_torch_burg import _model_burg
from test_torch_pipeline import KEYS, _assert_key
from voxtpu_torch.ops import burg as B
from voxtpu_torch.ops import ct_fused
from voxtpu_torch.pipeline import analyze_frames, config_from_jax

SR = 44100.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixture_frames(n, B=2, f0=150.0):
    """tests/test_large_frames.py's frames: 150 Hz and its third harmonic,
    each frame 5% quieter than the one before, in float64."""
    t = np.arange(n) / SR
    x = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 3 * f0 * t)
    return np.stack([x * (1.0 - 0.05 * i) for i in range(B)])


def _noisy_frames(n, dt, B=2, noise=0.1):
    """The mixture plus seeded noise (tests/test_large_frames.py:
    _noisy_frames): Burg on a near-pure long sine is ill-conditioned."""
    rng = np.random.default_rng(7)
    return (_mixture_frames(n, B) + noise * rng.standard_normal((B, n))).astype(dt)


def _config(n):
    return jp.AnalysisConfig(
        sample_rate=SR, frame_len=n, hop=n // 4,
        pitch=jp.PitchConfig(fmin=60.0, fmax=600.0, max_candidates=16),
        formant=jp.FormantConfig(n_coeffs=13),
        mfcc=jp.MfccConfig(num_coeffs=13, freq_hi=8000.0),
    )


@pytest.fixture(scope="module", params=[8192, 16384])
def large_slice(request):
    """{"noisy": (got, want), "pure": (got, want)} at frame length n."""
    n = request.param
    jcfg = _config(n)
    runs = {}
    for name, x in (("noisy", _noisy_frames(n, np.float64)), ("pure", _mixture_frames(n))):
        want = {k: np.asarray(v) for k, v in jp.analyze_frames(jnp.asarray(x), jcfg).items()}
        got = {k: v.numpy() for k, v in analyze_frames(torch.as_tensor(x), config_from_jax(jcfg)).items()}
        runs[name] = got, want
    return n, runs


@pytest.mark.parametrize("key", KEYS)
def test_analyze_frames_matches_jax(large_slice, key):
    _n, runs = large_slice
    _assert_key(key, *runs["noisy"], SR)
    if not key.startswith("formant"):
        _assert_key(key, *runs["pure"], SR)


def test_large_frames_are_healthy(large_slice):
    """tests/test_large_frames.py:44-52 on the pure frames: status 0, finite
    MFCC, and f0 the true period or an integer division of it; and kernel
    E's gate takes the frame in both dtypes."""
    n, runs = large_slice
    got, _ = runs["pure"]
    assert np.all(got["status"] == 0)
    assert np.all(np.isfinite(got["mfcc"]))
    f0 = got["f0"]
    assert np.all(f0 > 0)
    ratio = 150.0 / f0
    np.testing.assert_allclose(ratio, np.round(ratio), atol=5e-3)
    assert all(ct_fused.ct_fused_supported(n, 2 * n, dt) for dt in (torch.float32, torch.float64))


@pytest.mark.parametrize("dt, tol", [
    # tests/test_torch_burg.py's tolerances for the kernel against its plain
    # version: the sums are taken in float64 in both dtypes, in another
    # order by each.
    (np.float64, (1e-10, 1e-12)),
    (np.float32, (1e-4, 1e-5)),
])
def test_burg_32768_matches_jax(dt, tol):
    """Order 13 over two noisy frames of 32,768: the launch the rule gives is
    the cluster layout (2 blocks of 288 threads of 63 pairs in float32, 4 of
    160 in float64); `burg_plain` and the kernel's model against voxtpu's
    Burg, the statuses equal."""
    n = 32768
    config = B.launch_config(n, torch.float64 if dt == np.float64 else torch.float32)
    assert config == (("cluster", 160, 63, 4) if dt == np.float64 else ("cluster", 288, 63, 2))
    x = _noisy_frames(n, dt)
    jax_burg_jit = jax.jit(jax_burg, static_argnums=1, static_argnames="backend")
    want, wstatus = (np.asarray(v) for v in jax_burg_jit(jnp.asarray(x), 13, backend="jnp"))
    got, gstatus = (t.numpy() for t in B.burg_plain(torch.as_tensor(x), 13))
    cm, sm = _model_burg(x, 13, config.threads, config.width, config.blocks)
    for coef, status in ((got, gstatus), (cm, sm)):
        np.testing.assert_allclose(coef, want, rtol=tol[0], atol=tol[1])
        np.testing.assert_array_equal(status, wstatus)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_is_voxtpus_on_powers_of_two(dtype):
    """E's gate is voxtpu's fused gate on every power-of-two frame, nfft =
    2n and 4n: 128 to 16,384 at nfft = 2n, in either dtype."""
    for k in range(6, 17):
        n = 1 << k
        for nfft in (2 * n, 4 * n):
            assert ct_fused.ct_fused_supported(n, nfft, dtype) == jax_ct_fused_supported(n, nfft), (n, nfft)
    admitted = [1 << k for k in range(6, 17) if ct_fused.ct_fused_supported(1 << k, 2 << k, dtype)]
    assert admitted == [1 << k for k in range(7, 15)]
