"""Kernels B, C and D's plain versions and the formant stage of
voxtpu_torch against voxtpu on the CPU.

- `burg_plain` vs `voxtpu.lpc.burg(backend="jnp")`: rtol 1e-10 / atol 1e-12,
  status equal (tests/test_pallas.py:160), plus the all-zero status case;
- `find_roots_plain` vs `voxtpu.roots.find_roots(backend="jnp")`: 1e-10;
- `formant_scan_plain` vs `voxtpu.formants.formant_tracker(backend="jnp")`:
  bit-exact, plus tests/test_pallas.py:95-115's golden trajectory.
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from voxtpu import errors as jerrors
from voxtpu.cplx import C as JC
from voxtpu.formants import estimate_formants_step as jax_step
from voxtpu.formants import find_formants as jax_find_formants
from voxtpu.formants import formant_candidates as jax_formant_candidates
from voxtpu.formants import formant_tracker as jax_tracker
from voxtpu.formants import resample_linear as jax_resample_linear
from voxtpu.lpc import burg as jax_burg
from voxtpu.lpc import levinson as jax_levinson
from voxtpu.resonance import resonances_from_roots as jax_resonances
from voxtpu.resonance import sort_and_pack_resonances as jax_sort_pack
from voxtpu.roots import find_roots as jax_find_roots
from voxtpu.roots import polish_roots as jax_polish_roots

from util import synth_vowel
from voxtpu_torch import errors, formants, lpc, resonance, roots
from voxtpu_torch.cplx import C
from voxtpu_torch.ops.burg import burg_plain
from voxtpu_torch.ops.find_roots import find_roots_plain
from voxtpu_torch.ops.formant_scan import formant_scan, formant_scan_plain

# One compiled program per reference call (eager JAX compiles every op).
jax_burg = jax.jit(jax_burg, static_argnums=1, static_argnames="backend")
jax_levinson = jax.jit(jax_levinson, static_argnums=1)
jax_tracker = jax.jit(jax_tracker, static_argnames="backend")
jax_find_formants = jax.jit(jax_find_formants, static_argnums=(1, 2), static_argnames="resample_ratio")
jax_formant_candidates = jax.jit(jax_formant_candidates, static_argnums=(1, 2), static_argnames="resample_ratio")


@partial(jax.jit, static_argnames="backend")
def _jax_find_roots(re, im, backend):
    return jax_find_roots(JC(re, im), backend=backend)


EST_F = (320.0, 1440.0, 2760.0, 3200.0)


def _t(x):
    return torch.as_tensor(np.array(x))  # a writable copy (JAX arrays are read-only)


def test_error_flags_match_jax():
    for name in ("OK", "LPC_DENUM_NONPOS", "POLY_ZERO_DEGREE", "POLY_DIV_ZERO", "PITCH_UNVOICED_ONLY", "NONFINITE_INPUT"):
        assert getattr(errors, name) == getattr(jerrors, name)
    assert errors.describe(0b10011) == jerrors.describe(0b10011)


# ---------------------------------------------------------------- kernel B


@pytest.mark.parametrize("shape, order", [((11, 256), 13), ((5, 2205), 13), ((4, 64), 18)])
def test_burg_plain_matches_jax(shape, order):
    x = np.random.default_rng(shape[1]).standard_normal(shape)
    c1, s1 = jax_burg(jnp.asarray(x), order, backend="jnp")
    c2, s2 = burg_plain(torch.as_tensor(x), order)
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    c3, s3 = lpc.burg(torch.as_tensor(x), order)  # through the wrapper
    np.testing.assert_array_equal(c3.numpy(), c2.numpy())
    np.testing.assert_array_equal(s3.numpy(), s2.numpy())


def test_burg_all_zero_sets_status():
    c, s = burg_plain(torch.zeros((3, 64)), 4)
    assert np.all(s.numpy() & errors.LPC_DENUM_NONPOS)
    assert np.all(np.isfinite(c.numpy()))
    c2, s2 = jax_burg(jnp.zeros((3, 64)), 4, backend="jnp")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s2))
    np.testing.assert_allclose(c.numpy(), np.asarray(c2), rtol=1e-10, atol=1e-12)


def test_burg_batched_leading_axes():
    x = np.random.default_rng(3).standard_normal((2, 3, 128))
    c, s = lpc.burg(torch.as_tensor(x), 8)
    c1, s1 = jax_burg(jnp.asarray(x), 8, backend="jnp")
    assert c.shape == (2, 3, 8) and s.shape == (2, 3)
    np.testing.assert_allclose(c.numpy(), np.asarray(c1), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))


def test_levinson_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 400))
    ac = np.stack([np.correlate(r, r, "full")[399:420] for r in x])
    np.testing.assert_allclose(lpc.levinson(torch.as_tensor(ac), 12).numpy(),
                               np.asarray(jax_levinson(jnp.asarray(ac), 12)), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------- kernel C


def _polys(seed, B, N):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((B, N)) * 0.5
    re[:, -1] = 1.0  # monic, like the LPC polynomials
    im = np.zeros((B, N))
    im[1] = 0.3 * rng.standard_normal(N)  # one genuinely complex polynomial
    re[2, :2] = 0.0  # two leading zeros: zero roots shift out (off_low = 2)
    re[3, 3:] = 0.0
    im[3, 3:] = 0.0  # degree 2: only the quadratic tail
    re[4, 2:] = 0.0
    im[4, 2:] = 0.0  # degree 1: linear tail
    re[5] = 0.0
    im[5] = 0.0
    re[5, 0] = 2.0  # degree 0: POLY_ZERO_DEGREE
    return re, im


@pytest.mark.parametrize("N", [14, 11, 5])
def test_find_roots_plain_matches_jax(N):
    re, im = _polys(N, 8, N)
    want, wcount, wstatus = _jax_find_roots(jnp.asarray(re), jnp.asarray(im), backend="jnp")
    rre, rim, count, status = find_roots_plain(torch.as_tensor(re), torch.as_tensor(im))
    np.testing.assert_allclose(rre.numpy(), np.asarray(want.re), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rim.numpy(), np.asarray(want.im), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    np.testing.assert_array_equal(status.numpy(), np.asarray(wstatus))
    assert status[5] & errors.POLY_ZERO_DEGREE
    got = roots.find_roots(C(torch.as_tensor(re), torch.as_tensor(im)))  # through the wrapper
    np.testing.assert_array_equal(got[0].re.numpy(), rre.numpy())


def test_find_roots_plain_lpc_polynomials_match_jax():
    x = np.random.default_rng(8).standard_normal((6, 2205)) * np.hanning(2205)
    coeffs, _ = burg_plain(torch.as_tensor(x), 13)
    poly = np.concatenate([coeffs.numpy()[:, ::-1], np.ones((6, 1))], axis=-1)
    want, _, _ = _jax_find_roots(jnp.asarray(poly), jnp.zeros_like(jnp.asarray(poly)), backend="jnp")
    rre, rim, _, status = find_roots_plain(torch.as_tensor(poly), torch.zeros((6, 14), dtype=torch.float64))
    np.testing.assert_allclose(rre.numpy(), np.asarray(want.re), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rim.numpy(), np.asarray(want.im), rtol=1e-10, atol=1e-10)
    assert not status.any()


def test_polish_roots_f32_matches_jax():
    x = np.random.default_rng(9).standard_normal((5, 1024)) * np.hanning(1024)
    c, _ = burg_plain(torch.as_tensor(x), 12)
    poly = np.concatenate([c.numpy()[:, ::-1], np.ones((5, 1))], axis=-1).astype(np.float32)
    zeros = np.zeros_like(poly)
    r = find_roots_plain(torch.as_tensor(poly), torch.as_tensor(zeros))
    got = roots.polish_roots(C(torch.as_tensor(poly), torch.as_tensor(zeros)), C(r[0], r[1]))
    want = jax_polish_roots(JC(jnp.asarray(poly), jnp.asarray(zeros)), JC(jnp.asarray(r[0].numpy()), jnp.asarray(r[1].numpy())))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=1e-6, atol=1e-6)


def test_resonances_match_jax():
    rng = np.random.default_rng(10)
    re, im = rng.uniform(-1.2, 1.2, (2, 4, 14))
    im[0, :3] = 0.0
    got = resonance.resonances_from_roots(C(_t(re), _t(im)), 16000.0)
    want = jax_resonances(JC(jnp.asarray(re), jnp.asarray(im)), 16000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    # Same inputs to the sort/pack: the order and zero tails match exactly.
    gf, gb = resonance.sort_and_pack_resonances(*(_t(np.asarray(w)) for w in want), 32)
    wf, wb = jax_sort_pack(*want, 32)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


# ---------------------------------------------------------------- kernel D


def _resonance_rows(seed, F, R=32):
    """Sorted positive resonances with zero tails of varying length
    (tests/test_pallas.py:72-83)."""
    rng = np.random.default_rng(seed)
    rf = np.sort(rng.uniform(100, 4000, (F, R)), axis=1)
    rb = rng.uniform(10, 300, (F, R))
    for i in range(F):
        k = rng.integers(3, 9)
        rf[i, k:] = 0.0
        rb[i, k:] = 0.0
    return rf, rb


@pytest.mark.parametrize("seed, F, L", [(3, 12, 4), (4, 40, 4), (5, 20, 3), (6, 20, 8)])
def test_formant_scan_plain_bit_exact_vs_jax(seed, F, L):
    rf, rb = _resonance_rows(seed, F)
    if seed == 4:
        rf[5:9] = rf[4]  # repeated rows: ties in the nearest match and the dedup
        rb[5:9] = rb[4]
    est_f = np.array([320.0, 1440.0, 2760.0, 3200.0, 3520.0, 4000.0, 4500.0, 5000.0])[:L]
    est_b = np.ones(L)
    f1, b1 = jax_tracker(jnp.asarray(rf), jnp.asarray(rb), jnp.asarray(est_f), jnp.asarray(est_b), backend="jnp")
    f2, b2 = formant_scan_plain(_t(rf), _t(rb), _t(est_f), _t(est_b))
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b1))
    f3, _ = formants.formant_tracker(_t(rf), _t(rb), _t(est_f), _t(est_b))
    np.testing.assert_array_equal(f3.numpy(), f2.numpy())


def test_formant_scan_plain_golden_trajectory():
    resonances = np.array([
        [100.0, 150.0, 200.0, 240.0, 300.0],
        [110.0, 180.0, 210.0, 230.0, 310.0],
        [230.0, 270.0, 290.0, 350.0, 360.0],
    ])
    freqs, _ = formant_scan_plain(_t(resonances), _t(np.ones_like(resonances)), _t([140.0, 230.0, 320.0]), _t(np.ones(3)))
    np.testing.assert_allclose(freqs.numpy()[0], [150.0, 240.0, 300.0])
    np.testing.assert_allclose(freqs.numpy()[1], [180.0, 230.0, 310.0])
    np.testing.assert_allclose(freqs.numpy()[2], [230.0, 270.0, 290.0])


def test_formant_scan_file_len_resets_carry():
    files, F = 3, 10
    rf, rb = _resonance_rows(17, files * F)
    est_f, est_b = _t(EST_F), _t(np.ones(4))
    bf, bb = formant_scan(_t(rf), _t(rb), est_f, est_b, file_len=F)
    for i in range(files):
        sf, sb = jax_tracker(jnp.asarray(rf[i * F:(i + 1) * F]), jnp.asarray(rb[i * F:(i + 1) * F]),
                             jnp.asarray(EST_F), jnp.ones(4), backend="jnp")
        np.testing.assert_array_equal(bf.numpy()[i * F:(i + 1) * F], np.asarray(sf))
        np.testing.assert_array_equal(bb.numpy()[i * F:(i + 1) * F], np.asarray(sb))
    with pytest.raises(ValueError, match="multiple"):
        formant_scan(_t(rf), _t(rb), est_f, est_b, file_len=7)


def test_estimate_formants_step_batched_matches_jax():
    rf, rb = _resonance_rows(21, 6)
    ef = np.random.default_rng(22).uniform(200, 3500, (6, 4))
    eb = np.ones((6, 4))
    f1, b1 = jax_step(jnp.asarray(ef), jnp.asarray(eb), jnp.asarray(rf), jnp.asarray(rb))
    f2, b2 = formants.estimate_formants_step(_t(ef), _t(eb), _t(rf), _t(rb))
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b1))


# ---------------------------------------------------------------- formant stage


@pytest.mark.parametrize("sr, n, order, ratio", [(44100.0, 2205, 13, 1.0), (11025.0, 512, 10, 0.5)])
def test_find_formants_matches_jax(sr, n, order, ratio):
    sig = synth_vowel(sr, 120.0, [(700.0, 80.0), (1200.0, 90.0), (2600.0, 120.0)], 12 * n // 2 + n, noise=1e-3)
    frames = np.stack([sig[i * n // 2: i * n // 2 + n] for i in range(12)])
    jf, jb, js = jax_find_formants(jnp.asarray(frames), sr, order, resample_ratio=ratio)
    tf, tb, ts = formants.find_formants(torch.as_tensor(frames), sr, order, resample_ratio=ratio)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-7, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rf1, rb1, _ = jax_formant_candidates(jnp.asarray(frames), sr, order, resample_ratio=ratio)
    rf2, rb2, _ = formants.formant_candidates(torch.as_tensor(frames), sr, order, resample_ratio=ratio)
    np.testing.assert_allclose(rf2.numpy(), np.asarray(rf1), rtol=1e-7, atol=1e-5)
    np.testing.assert_allclose(rb2.numpy(), np.asarray(rb1), rtol=1e-6, atol=1e-4)


def test_resample_linear_matches_jax():
    x = np.random.default_rng(12).standard_normal((3, 300))
    for ratio, out_len in ((0.5, 150), (1.7, 510), (1.0, 300)):
        np.testing.assert_allclose(
            formants.resample_linear(torch.as_tensor(x), ratio, out_len).numpy(),
            np.asarray(jax_resample_linear(jnp.asarray(x), ratio, out_len)), rtol=1e-12, atol=1e-12,
        )
