"""Kernel G's plain version (`voxtpu_torch.ops.pitch_pre.pitch_pre_plain`,
the PyTorch twin of csrc/pitch_pre.cu) against voxtpu on the CPU.

- Against `voxtpu.ops.pitch_pre_pallas.pitch_pre_pallas(interpret=True)` at
  n = 1024 in float32 on seeded noise with one all-zero row, as
  tests/test_pallas.py:340-384 builds it. XLA folds the two divisions
  (/ max, / lag window) into one under jit (tests/test_pallas.py:342-345)
  and eager PyTorch does not, so self_lag agrees within 2 float32 ulps
  (rtol 2 eps_f32); cand is identical and freq within rtol 2e-6 where cand.
  freq carries self_lag's ulps through dr / d2r, whose d2r = (s - left) +
  (s - right) cancels, and XLA divides sr / x where PyTorch multiplies
  x.reciprocal() by sr: one of 416 candidates differs by 1.07e-6.
- Against the jnp block of voxtpu/pitch.py:124-161 in float64 at n = 2205
  and 4096 on Hann-windowed frames of short_sample.wav and
  sample-two_vowels.wav: rtol 1e-13, cand identical.
- A NaN row and an all-zero row give all-zero outputs.
- `lag_candidates` on the CPU returns what it returned before kernel G
  carried steps 1-3 (a frozen copy of that code below), bit for bit; only
  `freq` on dead lanes changed, from an unspecified non-candidate lag's
  frequency to 0 (every consumer masks those lanes).
"""

import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from voxtpu.autocorr import autocorrelate as jax_autocorrelate
from voxtpu.io_wav import read_wav
from voxtpu.ops.pitch_pre_pallas import pitch_pre_pallas
from voxtpu.windows import hann, hanning_lag

from voxtpu_torch import pitch
from voxtpu_torch.autocorr import autocorrelate
from voxtpu_torch.ops.pitch_pre import pitch_pre, pitch_pre_plain
from voxtpu_torch.windows import hanning_lag as torch_hanning_lag

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(ac, hl, bi, sr, fmin, fmax):
    return [t.numpy() for t in pitch_pre_plain(torch.as_tensor(ac), torch.as_tensor(hl), bi, sr, fmin, fmax)]


@pytest.fixture(scope="module")
def pallas_case():
    """tests/test_pallas.py:352-358's inputs and the Pallas kernel's outputs."""
    rng = np.random.default_rng(5)
    n, sr, fmin, fmax = 1024, 11025.0, 60.0, 500.0
    bi = n // 2
    x = rng.standard_normal((9, n)).astype(np.float32)
    x[3] = 0.0  # degenerate frame: NaN row must zero, not poison
    ac = np.array(jax_autocorrelate(jnp.asarray(x), n))
    hl = np.asarray(hanning_lag(n), np.float32)
    want = [np.asarray(v) for v in pitch_pre_pallas(jnp.asarray(ac), hl, n, bi, sr, fmin, fmax, interpret=True)]
    return (ac, hl, bi, sr, fmin, fmax), want


@pytest.mark.parametrize("out", ["self_lag", "freq", "cand"])
def test_plain_matches_pallas_interpret_f32(pallas_case, out):
    args, want = pallas_case
    got = _plain(*args)
    i = ["self_lag", "freq", "cand"].index(out)
    assert got[i].shape == want[i].shape and got[i].dtype == want[i].dtype
    if out == "self_lag":
        np.testing.assert_allclose(got[0], want[0], rtol=2 * EPS32, atol=0)
        assert not got[0][3].any() and not got[0][:, 1024:].any()
    elif out == "cand":
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].sum() > 20  # noise has maxima in band on every live row
    else:
        c = want[2]
        np.testing.assert_allclose(got[1][c], want[1][c], rtol=2e-6)
        assert not got[1][~got[2]].any()


def test_lags_0_and_last_are_never_candidates(pallas_case):
    args, _ = pallas_case
    _, freq, cand = _plain(*args)
    bi = args[2]
    assert not cand[:, 0].any() and not cand[:, bi - 1].any()
    assert not freq[:, 0].any() and not freq[:, bi - 1].any()


def _jnp_block(ac, hl, bi, sr, fmin, fmax):
    """voxtpu/pitch.py:124-161 (normalize .. band filter) under jit, with
    lag-indexed outputs, as tests/test_pallas.py:360-374 writes it."""

    @jax.jit
    def block(ac):
        sl = ac / jnp.max(jnp.abs(ac), axis=-1, keepdims=True)
        sl = sl / jnp.asarray(hl)
        sl = jnp.where(jnp.isfinite(sl), sl, jnp.zeros_like(sl))
        sl = jnp.concatenate([sl, jnp.zeros_like(sl)], axis=-1)
        seg = sl[:, :bi]
        is_max = (seg[:, :-2] < seg[:, 1:-1]) & (seg[:, 2:] < seg[:, 1:-1])
        ix = jnp.arange(1, bi - 1)
        peak, rev, fwd = seg[:, 1:-1], seg[:, :-2], seg[:, 2:]
        dr = 0.5 * (fwd - rev)
        d2r = 2.0 * peak - (rev - fwd)
        freq = sr / (ix.astype(ac.dtype)[None, :] + dr / d2r)
        cand = is_max & ((freq == 0.0) | ((freq > fmin) & (freq < fmax)))
        pad = ((0, 0), (1, 1))
        return sl, jnp.pad(jnp.where(cand, freq, 0.0), pad), jnp.pad(cand, pad)

    return [np.asarray(v) for v in block(jnp.asarray(ac))]


def _windowed_frames(name, n, hop):
    wav = read_wav(os.path.join(FIX, name))
    x = np.asarray(wav.samples, np.float64)
    if len(x) < n + 4 * hop:  # short_sample.wav is 2878 samples: a zero tail
        x = np.concatenate([x, np.zeros(n + 4 * hop - len(x))])
    F = (len(x) - n) // hop + 1
    frames = np.stack([x[i * hop : i * hop + n] for i in range(F)] + [np.zeros(n)])
    return frames * hann(n), float(wav.sample_rate)


@pytest.mark.parametrize("name, n, hop", [
    ("short_sample.wav", 2205, 64), ("short_sample.wav", 4096, 128),
    ("sample-two_vowels.wav", 2205, 4410), ("sample-two_vowels.wav", 4096, 4096),
])
def test_plain_matches_jnp_block_f64(name, n, hop):
    frames, sr = _windowed_frames(name, n, hop)
    bi = n // 2
    ac = np.array(jax_autocorrelate(jnp.asarray(frames), n))
    hl = np.asarray(hanning_lag(n))
    args = (ac, hl, bi, sr, 60.0, 600.0)
    want = _jnp_block(*args)
    got = _plain(*args)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-13, atol=0)
    np.testing.assert_array_equal(got[2], want[2])
    c = want[2]
    np.testing.assert_allclose(got[1][c], want[1][c], rtol=1e-13)
    assert not got[1][~c].any()
    assert c[:-1].any(axis=-1).sum() >= 3 and not c[-1].any()  # speech has candidates, the zero frame none


def test_torch_hanning_lag_equals_voxtpu():
    for n in (1024, 2205, 4096):
        np.testing.assert_array_equal(torch_hanning_lag(n), hanning_lag(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_and_zero_rows_give_zeros(dtype):
    rng = np.random.default_rng(3)
    n = 512
    ac = torch.as_tensor(rng.standard_normal((4, n)), dtype=dtype)
    ac[1, 17] = float("nan")
    ac[2] = 0.0
    hl = torch.as_tensor(torch_hanning_lag(n), dtype=dtype)
    sl, freq, cand = pitch_pre_plain(ac, hl, n // 2, 8000.0, 60.0, 600.0)
    for row in (1, 2):
        assert not sl[row].any() and not freq[row].any() and not cand[row].any()
    assert torch.isfinite(sl).all() and torch.isfinite(freq).all()
    assert sl[0].any() and sl[3].any()


def test_wrapper_runs_the_plain_version_for_cpu_tensors(pallas_case):
    (ac, hl, bi, sr, fmin, fmax), _ = pallas_case
    before = pitch_pre.launches
    got = pitch_pre(torch.as_tensor(ac), torch.as_tensor(hl), bi, sr, fmin, fmax)
    want = pitch_pre_plain(torch.as_tensor(ac), torch.as_tensor(hl), bi, sr, fmin, fmax)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert pitch_pre.launches == before  # only a kernel launch counts
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        pitch_pre(torch.as_tensor(ac), torch.as_tensor(hl, device="meta"), bi, sr, fmin, fmax)


def _lag_candidates_before_kernel_g(frames, sample_rate, fmin, fmax, max_candidates, precomputed_ac=None):
    """voxtpu_torch.pitch.lag_candidates as it was before kernel G carried
    steps 1-3 (frozen copy)."""
    n = frames.shape[-1]
    dt, dev = frames.dtype, frames.device
    self_lag = autocorrelate(frames, n) if precomputed_ac is None else precomputed_ac
    self_lag = self_lag / torch.amax(torch.abs(self_lag), dim=-1, keepdim=True)
    self_lag = self_lag / torch.as_tensor(torch_hanning_lag(n), dtype=dt, device=dev)
    self_lag = torch.where(torch.isfinite(self_lag), self_lag, 0.0)
    self_lag = torch.cat([self_lag, torch.zeros_like(self_lag)], dim=-1).contiguous()
    bi = int(math.floor(0.5 * n))
    C = min(max_candidates, bi - 2)
    seg = self_lag[:, :bi]
    peak, peak_rev, peak_fwd = seg[:, 1:-1], seg[:, :-2], seg[:, 2:]
    is_max = (peak_rev < peak) & (peak_fwd < peak)
    ix = torch.arange(1, bi - 1, device=dev)
    dr = 0.5 * (peak_fwd - peak_rev)
    d2r = 2.0 * peak - (peak_rev - peak_fwd)
    freq = sample_rate / (ix.to(dt)[None, :] + dr / d2r)
    cand = is_max & ((freq == 0.0) | ((freq > fmin) & (freq < fmax)))
    keys = torch.where(cand, ix[None, :], bi)
    kvals, order = torch.topk(keys, C, dim=-1, largest=False, sorted=True)
    valid = kvals < bi
    freq_c = torch.gather(freq, 1, order)
    offset = -bi - 1
    pos = sample_rate / freq_c - offset
    pos = torch.where(valid, pos, float(bi) + 0.5)
    return self_lag, freq_c, valid, pos, bi, offset, bi - offset, sample_rate / fmin - offset


@pytest.mark.parametrize("name, n, hop, dtype", [
    ("sample-two_vowels.wav", 2205, 4410, torch.float64), ("sample-two_vowels.wav", 2205, 4410, torch.float32),
    ("sample-two_vowels.wav", 4096, 4096, torch.float32), ("short_sample.wav", 512, 256, torch.float64),
])
def test_lag_candidates_unchanged_bit_for_bit(name, n, hop, dtype):
    frames, sr = _windowed_frames(name, n, hop)
    x = torch.as_tensor(frames, dtype=dtype)
    old = _lag_candidates_before_kernel_g(x, sr, 60.0, 600.0, 32)
    new = pitch.lag_candidates(x, sr, 60.0, 600.0, 32)
    assert torch.equal(new.self_lag, old[0])
    assert torch.equal(new.valid, old[2]) and new.valid.any()
    assert torch.equal(new.freq[new.valid], old[1][old[2]])
    assert not new.freq[~new.valid].any()
    assert torch.equal(new.pos, old[3])
    assert (new.bi, new.offset, new.nx, new.max_x) == old[4:]
