"""Kernel A's plain version and the pitch stage of voxtpu_torch against
voxtpu on the CPU.

`refine_plain` (the PyTorch twin of csrc/refine.cu) is held against
`voxtpu.sinc.brent_maximize_sinc` at tests/test_pallas.py:51-52's
tolerances in float64 (Brent's trajectory is chaotic in the last ulp of the
tap sums, so agreement is to Brent's own tolerance) and at the f32 fuzz
test's bracket in float32. `pitch_frames` is held against
`voxtpu.pitch.pitch_frames(refine_backend="jnp")`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from voxtpu.pitch import pitch_frames as jax_pitch_frames
from voxtpu.sinc import _max_effective_depth as jax_max_effective_depth
from voxtpu.sinc import brent_maximize_sinc as jax_brent_maximize_sinc
from voxtpu.sinc import improve_extremum_sinc as jax_improve_extremum_sinc
from voxtpu.sinc import interpolate_sinc as jax_interpolate_sinc
from voxtpu.windows import hann

from util import sine_hz
from voxtpu_torch import pitch, sinc
from voxtpu_torch.ops.refine import refine, refine_plain

# One compiled program per reference call (eager JAX compiles every op).
jax_brent_maximize_sinc = jax.jit(jax_brent_maximize_sinc, static_argnums=(1, 2, 4), static_argnames=("max_x",))
jax_interpolate_sinc = jax.jit(jax_interpolate_sinc, static_argnums=(1, 2, 4), static_argnames=("max_x",))
jax_improve_extremum_sinc = jax.jit(jax_improve_extremum_sinc, static_argnums=(1, 2, 4),
                                    static_argnames=("max_x", "backend"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lag_rows(seed, n, B, period=37.0, dtype=np.float64):
    """Smooth-ish lag buffers with real peaks, like a normalized
    autocorrelation (tests/test_pallas.py:15-30)."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * n)
    y = np.cos(2 * np.pi * t / period) * np.exp(-t / 800.0) + 0.05 * rng.standard_normal(2 * n)
    return np.stack([np.roll(y, 3 * i) for i in range(B)]).astype(dtype), rng


@pytest.mark.parametrize("seed, n", [(0, 256), (1, 256), (2, 512), (3, 2205)])
def test_refine_plain_matches_jax_brent(seed, n):
    bi = n // 2
    offset = -bi - 1
    nx = bi - offset
    B, C = 3, 8
    ys, rng = _lag_rows(seed, n, B)
    x0 = rng.uniform(20.0, bi - 4, (B, C)) - offset + rng.uniform(-0.4, 0.4, (B, C))
    valid = rng.random((B, C)) < 0.8
    valid[:, 0] = True
    max_x = float(bi + 2 - offset)
    T = sinc._max_effective_depth(offset, nx, 1200, max_x)
    assert T == jax_max_effective_depth(offset, nx, 1200, max_x)

    xe, fe = jax_brent_maximize_sinc(
        jnp.asarray(ys), offset, nx, jnp.asarray(x0), 1200, max_x=max_x, lane_mask=jnp.asarray(valid)
    )
    xp, fp = refine_plain(torch.as_tensor(ys), torch.as_tensor(x0), torch.as_tensor(valid), offset, 1200, T)
    m = valid
    np.testing.assert_allclose(xp.numpy()[m], np.asarray(xe)[m], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(fp.numpy()[m], np.asarray(fe)[m], rtol=1e-5, atol=1e-7)
    # The dispatching wrapper takes the plain path for CPU tensors.
    xw, fw = refine(torch.as_tensor(ys), torch.as_tensor(x0), torch.as_tensor(valid), offset, 1200, T)
    np.testing.assert_array_equal(xw.numpy(), xp.numpy())
    np.testing.assert_array_equal(fw.numpy(), fp.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_refine_plain_f32_matches_jax_brent_f32(seed):
    """f32 at the f32 fuzz test's bracket (tests/test_pallas.py:224-235):
    Brent stops at tol_act ~ sqrt(eps_f32)|x|, so two f32 tap-sum orders
    agree to that bracket, not to f32 eps."""
    n = 256
    bi = n // 2
    offset = -bi - 1
    nx = bi - offset
    max_x = float(bi + 2 - offset)
    T = sinc._max_effective_depth(offset, nx, 1200, max_x)
    rng = np.random.default_rng(100 + seed)  # tests/test_pallas.py:183-193's signals
    t = np.arange(2 * n)
    period = rng.uniform(17.0, 61.0)
    decay = rng.uniform(400.0, 1200.0)
    y = (np.cos(2 * np.pi * t / period) * np.exp(-t / decay) + 0.01 * rng.standard_normal(2 * n)).astype(np.float32)
    ys = np.stack([np.roll(y, i * 5) for i in range(4)])
    x0 = np.full((4, 8), float(bi), np.float32)
    valid = np.zeros((4, 8), bool)
    for b in range(4):
        row = ys[b]
        peaks = [i for i in range(22, bi - 6) if row[i] > row[i - 1] and row[i] > row[i + 1]]
        for c, pk in enumerate(peaks[:8]):
            x0[b, c] = pk - offset + rng.uniform(-0.3, 0.3)
            valid[b, c] = True
    assert valid.sum() >= 4
    xe, fe = jax_brent_maximize_sinc(
        jnp.asarray(ys), offset, nx, jnp.asarray(x0), 1200, max_x=max_x, lane_mask=jnp.asarray(valid)
    )
    xp, fp = refine_plain(torch.as_tensor(ys), torch.as_tensor(x0), torch.as_tensor(valid), offset, 1200, T)
    assert xp.dtype == torch.float32 and xe.dtype == jnp.float32
    np.testing.assert_allclose(xp.numpy()[valid], np.asarray(xe)[valid], atol=0.2)
    np.testing.assert_allclose(fp.numpy()[valid], np.asarray(fe)[valid], rtol=1e-3, atol=5e-4)


def test_refine_plain_eval_only_matches_interpolate_sinc():
    """iters=0 is kernel A's evaluation-only mode: f(x0) of the windowed
    sinc, which voxtpu's jnp path computes with interpolate_sinc."""
    n = 512
    bi = n // 2
    offset = -bi - 1
    nx = bi - offset
    ys, rng = _lag_rows(11, n, 2)
    x0 = rng.uniform(30.0, bi - 4, (2, 6)) - offset
    x0[0, 0] = np.floor(x0[0, 0])  # an exact integer takes the snap branch
    max_x = float(x0.max())
    T = sinc._max_effective_depth(offset, nx, 30, max_x)
    valid = torch.ones((2, 6), dtype=torch.bool)
    x, f = refine_plain(torch.as_tensor(ys), torch.as_tensor(x0), valid, offset, 30, T, iters=0)
    want = jax_interpolate_sinc(jnp.asarray(ys), offset, nx, jnp.asarray(x0), 30, max_x=max_x)
    np.testing.assert_array_equal(x.numpy(), x0)
    np.testing.assert_allclose(f.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    got = sinc.interpolate_sinc(torch.as_tensor(ys), offset, nx, torch.as_tensor(x0), 30, max_x=max_x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_improve_extremum_sinc_edges_match_jax():
    n = 256
    bi = n // 2
    offset = -bi - 1
    nx = bi - offset
    ys, rng = _lag_rows(5, n, 2)
    x0 = rng.uniform(20.0, bi - 4, (2, 5)) - offset
    x0[0, 1] = 0.0  # at_zero edge
    x0[1, 2] = float(nx + 3)  # past_end edge
    mask = np.ones((2, 5), bool)
    mx = float(nx + 4)
    want = jax_improve_extremum_sinc(jnp.asarray(ys), offset, nx, jnp.asarray(x0), 1200, max_x=mx,
                                     lane_mask=jnp.asarray(mask), backend="jnp")
    got = sinc.improve_extremum_sinc(torch.as_tensor(ys), offset, nx, torch.as_tensor(x0), 1200, max_x=mx,
                                     lane_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)
    assert got[0][0, 1] == 0.0 and got[0][1, 2] == float(nx)


def _frames(seed, n, B, sr):
    rng = np.random.default_rng(seed)
    rows = [sine_hz(f, sr, n) + 0.3 * sine_hz(2.1 * f, sr, n) + 0.05 * rng.standard_normal(n)
            for f in rng.uniform(90.0, 400.0, B)]
    rows.append(np.zeros(n))  # a degenerate frame: NaN lag row, unvoiced only
    return np.stack(rows) * hann(n)


def _knife_rtol(f0, sr, base):
    lag = np.where(f0 > 0, sr / np.where(f0 > 0, f0, 1.0), 0.0)
    return np.where(np.abs(lag - np.round(lag)) < 1e-3, 5e-3, base)


@pytest.mark.parametrize("n, sr, refine_mode", [
    (2205, 44100.0, "sinc"), (512, 11025.0, "sinc"), (800, 16000.0, "sinc"), (800, 16000.0, "parabolic"),
])
def test_pitch_frames_matches_jax(n, sr, refine_mode):
    x = _frames(n, n, 4, sr)
    kw = dict(threshold=0.2, fmin=60.0, fmax=600.0, max_candidates=16, refine=refine_mode)
    jf, js, jv = map(np.asarray, jax_pitch_frames(jnp.asarray(x), sr, refine_backend="jnp", **kw))
    tf, ts, tv = (t.numpy() for t in pitch.pitch_frames(torch.as_tensor(x), sr, **kw))
    np.testing.assert_array_equal(tv, jv)
    rt = _knife_rtol(jf, sr, 1e-5)
    assert np.all(np.abs(tf - jf) <= 1e-8 + rt * np.abs(jf)), np.abs(tf - jf).max()
    assert np.all(np.abs(ts - js) <= 1e-8 + rt * np.abs(js)), np.abs(ts - js).max()
    assert tv[-1].sum() == 1 and tf[-1, 0] == 0.0  # the zero frame: unvoiced only
    bf, bs = pitch.best_pitch(*(torch.as_tensor(a) for a in (tf, ts, tv)))
    np.testing.assert_array_equal(bf.numpy(), tf[:, 0])
    np.testing.assert_array_equal(bs.numpy(), ts[:, 0])


def test_pitch_frames_capacity_clamp_pads_like_jax():
    """More capacity than maxima centres (n = 64: 30 centres) pads the
    sorted outputs back out to the requested width."""
    x = _frames(7, 64, 2, 8000.0)
    kw = dict(fmin=150.0, fmax=1000.0, max_candidates=40)
    want = jax_pitch_frames(jnp.asarray(x), 8000.0, refine_backend="jnp", **kw)
    got = pitch.pitch_frames(torch.as_tensor(x), 8000.0, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 41)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-3, atol=1e-8)


def test_pitch_unknown_refine_mode_raises():
    with pytest.raises(ValueError, match="refine"):
        pitch.pitch_frames(torch.zeros((1, 256)), 8000.0, refine="cubic")
