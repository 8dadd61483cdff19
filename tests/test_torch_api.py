"""voxtpu_torch's top-level names against voxtpu's, and the three public
functions the port added last (`sinc.improve_extremum`,
`roots.div_polynomial`, `lpc.LPCSolver`) against voxtpu's on the CPU in
float64.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voxtpu
import voxtpu.lpc as jlpc
import voxtpu.roots as jroots
import voxtpu.sinc as jsinc
from voxtpu.cplx import C as JC

import voxtpu_torch
from voxtpu_torch import lpc, roots, sinc
from voxtpu_torch.cplx import C

# Names of voxtpu.__all__ the port leaves out on purpose, with the reason
# (ROADMAP.md §1 lists them).
ABSENT = {
    "mfcc": "the name is the module voxtpu_torch.mfcc (its function is voxtpu_torch.mfcc.mfcc): "
            "re-exported, the function would shadow the module for `from voxtpu_torch import mfcc`",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_all_covers_voxtpus_names():
    missing = set(voxtpu.__all__) - set(voxtpu_torch.__all__)
    assert missing == set(ABSENT), sorted(missing)
    assert voxtpu_torch.__version__ == voxtpu.__version__


def test_the_absent_name_is_the_module():
    from voxtpu_torch import mfcc

    assert mfcc.__name__ == "voxtpu_torch.mfcc" and callable(mfcc.mfcc)


@pytest.mark.parametrize("name", sorted(set(voxtpu.__all__) - set(ABSENT)))
def test_each_name_comes_from_the_same_module(name):
    """A function or class comes from the module of the same name in the
    port; constants equal voxtpu's."""
    ours, theirs = getattr(voxtpu_torch, name), getattr(voxtpu, name)
    if callable(ours) or isinstance(ours, type):
        assert ours.__module__ == theirs.__module__.replace("voxtpu", "voxtpu_torch", 1)
    elif name == "errors":
        assert ours.__name__ == "voxtpu_torch.errors"
    else:
        assert ours == theirs


# ---- improve_extremum (tests/test_pitch.py:117-165's cases)


def _y(seed=2, n=64):
    return np.random.default_rng(seed).standard_normal((1, n))


@pytest.mark.parametrize("ix", [0.0, 5.0, 7.0, 31.5, 32.0, 40.0])
def test_improve_extremum_none_and_parabolic(ix):
    y = _y()
    for mode in ("none", "parabolic"):
        gx, gy = sinc.improve_extremum(torch.as_tensor(y), 0, 32, torch.tensor([[ix]], dtype=torch.float64), mode)
        wx, wy = jsinc.improve_extremum(jnp.asarray(y), 0, 32, jnp.asarray([[ix]]), mode)
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-12, atol=1e-12)


def test_improve_extremum_parabolic_is_the_reference_transcription():
    """The quirky second difference 2*mid - (y[i+1] - y[i-1]) (periodic.rs:204)."""
    y = _y()
    xm, ym = sinc.improve_extremum(torch.as_tensor(y), 0, 32, [[7.0]], "parabolic")
    mid, rev, fwd = y[0, 7], y[0, 6], y[0, 8]
    diff = fwd - rev
    dy, d2y = 0.5 * diff, 2.0 * mid - diff
    assert abs(float(xm[0, 0]) - (7.0 + dy / d2y)) < 1e-12
    assert abs(float(ym[0, 0]) - (mid + 0.5 * dy * dy / d2y)) < 1e-12


@pytest.mark.parametrize("is_max", [True, False])
def test_improve_extremum_sinc(is_max):
    """The "sinc" branch on tests/test_pitch.py:134-160's signal: it is
    `improve_extremum_sinc` (bit for bit), which tests/test_torch_pitch.py
    holds to voxtpu's at rtol 1e-6 / atol 1e-5 for the positions and rtol
    1e-5 / atol 1e-7 for the values: Brent stops on brackets of about
    1e-10 where the extremum is flat, so rounding noise in the interpolant
    moves its last steps (here up to 5.8e-8 in x and 1.3e-8 in y). The
    edge case ixmid == 0 returns (0, y[0]) exactly."""
    rng = np.random.default_rng(13)
    t = np.arange(64)
    y = (np.cos(2 * np.pi * t / 17.0) + 0.1 * rng.standard_normal(64))[None]
    ix = np.asarray([[0.0, 5.0, 12.0, 29.0]])
    gx, gy = sinc.improve_extremum(torch.as_tensor(y), 0, 32, torch.as_tensor(ix), "sinc", max_depth=30,
                                   is_max=is_max)
    wx, wy = jsinc.improve_extremum(jnp.asarray(y), 0, 32, jnp.asarray(ix), "sinc", max_depth=30, is_max=is_max)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-5, atol=1e-7)
    same = sinc.improve_extremum_sinc(torch.as_tensor(y), 0, 32, torch.as_tensor(ix), 30, is_max=is_max)
    assert torch.equal(gx, same[0]) and torch.equal(gy, same[1])
    assert float(gx[0, 0]) == 0.0 and float(gy[0, 0]) == y[0, 0]


def test_improve_extremum_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown interpolation"):
        sinc.improve_extremum(torch.zeros((1, 8)), 0, 4, [[1.0]], "cubic")


# ---- div_polynomial


def test_div_polynomial_matches_voxtpu_and_numpy():
    """(x^2 + 2.5x - 2) / (x + 2.5), tests/test_roots.py:149's case, then a
    batch of complex degree-9 polynomials by complex constants."""
    c = C(torch.tensor([-2.0, 2.5, 1.0], dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    q, rem = roots.div_polynomial(c, C(torch.tensor(2.5, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64)))
    qn, rn = np.polydiv([1.0, 2.5, -2.0], [1.0, 2.5])
    np.testing.assert_allclose(q.re.numpy()[:2], qn[::-1], atol=1e-12)
    assert q.re[2] == 0 and rem.re[0] == pytest.approx(rn[-1], abs=1e-12) and torch.all(rem.re[1:] == 0)

    rng = np.random.default_rng(7)
    re, im = rng.standard_normal((2, 4, 10))
    zr, zi = rng.standard_normal((2, 4))
    q, rem = roots.div_polynomial(C(torch.as_tensor(re), torch.as_tensor(im)),
                                  C(torch.as_tensor(zr), torch.as_tensor(zi)))
    wq, wrem = jroots.div_polynomial(JC(jnp.asarray(re), jnp.asarray(im)), JC(jnp.asarray(zr), jnp.asarray(zi)))
    for got, want in ((q.re, wq.re), (q.im, wq.im), (rem.re, wrem.re), (rem.im, wrem.im)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


# ---- LPCSolver


def test_lpc_solver_matches_voxtpu():
    ac = np.random.default_rng(3).standard_normal((5, 20))
    ac[:, 0] = np.abs(ac[:, 0]) + 20.0
    ours, theirs = lpc.LPCSolver(12), jlpc.LPCSolver(12)
    with pytest.raises(RuntimeError, match="solve"):
        ours.lpc()
    ours.solve(torch.as_tensor(ac))
    theirs.solve(jnp.asarray(ac))
    assert ours.n_coeffs == 12 and ours.lpc().shape == (5, 13)
    np.testing.assert_allclose(ours.lpc().numpy(), np.asarray(theirs.lpc()), rtol=1e-12, atol=1e-12)
