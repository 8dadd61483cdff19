"""Kernel C's plain version against voxtpu on the edge rows that chip_smoke.py
holds the kernel to, and the wrapper's contract, on the CPU.

- `find_roots_plain` vs `voxtpu.roots.find_roots(backend="jnp")` on
  `chip_smoke.roots_edge_cases`: float64 at tests/test_torch_formants.py's
  1e-10, float32 at chip_smoke.py's `roots_tol` (1e-3), count and status
  equal; and on `chip_smoke.roots_order_cases` (N = 33, 64 and 128, the
  LPC orders 32-127 that the card takes since the kernel's capacity grew
  to 128) in float64 at 1e-10;
- the edge rows hold what they are named for (zero roots shifted out,
  leading zeros, linear and quadratic live parts, -0.0, POLY_DIV_ZERO);
- csrc/roots.cu's template N, capacity and block sizes mirror
  `ops/find_roots.py`, and its instantiations match phase 2's count;
- the wrapper refuses what neither version takes, runs the plain version,
  uncounted, for CPU tensors at any N, and refuses N > 128 on the card
  only (its mirror of the capacity).
"""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import STACK_CHECKED, roots_edge_cases, roots_order_cases
from voxtpu.cplx import C as JC
from voxtpu.roots import find_roots as jax_find_roots
from voxtpu_torch import errors
from voxtpu_torch.ops import find_roots as F

CU = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc" / "roots.cu"
TOL = {np.float64: 1e-10, np.float32: 1e-3}
NAMES = [name for name, _, _ in roots_edge_cases(np.float64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@partial(jax.jit, static_argnames="backend")
def _jax_find_roots(re_, im_, backend):
    return jax_find_roots(JC(re_, im_), backend=backend)


def _case(name: str, dt, cases=roots_edge_cases):
    return next((re_, im_) for n, re_, im_ in cases(dt) if n == name)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_on_edge_rows(name, dt):
    re_, im_ = _case(name, dt)
    want, wcount, wstatus = _jax_find_roots(jnp.asarray(re_), jnp.asarray(im_), backend="jnp")
    rre, rim, count, status = F.find_roots_plain(torch.as_tensor(re_), torch.as_tensor(im_))
    np.testing.assert_allclose(rre.numpy(), np.asarray(want.re), rtol=TOL[dt], atol=TOL[dt])
    np.testing.assert_allclose(rim.numpy(), np.asarray(want.im), rtol=TOL[dt], atol=TOL[dt])
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    np.testing.assert_array_equal(status.numpy(), np.asarray(wstatus))


@pytest.mark.parametrize("name", [name for name, _, _ in roots_order_cases(np.float64)])
def test_plain_matches_jax_at_high_orders(name):
    re_, im_ = _case(name, np.float64, roots_order_cases)
    want, wcount, wstatus = _jax_find_roots(jnp.asarray(re_), jnp.asarray(im_), backend="jnp")
    rre, rim, count, status = F.find_roots_plain(torch.as_tensor(re_), torch.as_tensor(im_))
    np.testing.assert_allclose(rre.numpy(), np.asarray(want.re), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rim.numpy(), np.asarray(want.im), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    np.testing.assert_array_equal(status.numpy(), np.asarray(wstatus))


def test_order_rows_hold_their_cases():
    """Each N has a row whose live part reaches the top (degree N - 1, or 32
    at N = 33), one under leading zeros, and ones whose zero roots shift out
    (low N - 14, and 5)."""
    for name, re_, im_ in roots_order_cases(np.float64):
        N = re_.shape[1]
        nz = (re_ != 0) | (im_ != 0)
        idx = np.arange(N)
        deg = np.where(nz, idx, 0).max(axis=1)
        low = np.where(nz, idx, N - 1).min(axis=1)
        assert name == f"N = {N}" and N in (33, 64, 128)
        assert deg.tolist() == [32 if N == 33 else 24, 12, N - 1, 25]
        assert low.tolist() == [0, 0, N - 14, 5]


def test_edge_rows_hold_their_cases():
    cases = dict((name, (re_, im_)) for name, re_, im_ in roots_edge_cases(np.float64))
    assert [cases[n][0].shape[1] for n in NAMES] == [14, 1, 2, 3, 32]
    re_, im_ = cases["N = 14"]
    nz = (re_ != 0) | (im_ != 0)
    idx = np.arange(14)
    deg = np.where(nz, idx, 0).max(axis=1)
    low = np.where(nz, idx, 13).min(axis=1)
    assert not nz[0].any() and deg[1] == 9
    assert low[2:5].tolist() == [1, 2, 3]
    assert (deg - low)[5:7].tolist() == [1, 2]
    assert np.signbit(re_[7, [0, 5, 13]]).all() and (low[7], deg[7]) == (1, 12)
    assert im_[9].any() and deg[9] == 7
    _, _, count, status = F.find_roots_plain(torch.as_tensor(re_), torch.as_tensor(im_))
    assert status.tolist() == [errors.POLY_ZERO_DEGREE] + [0] * 7 + [errors.POLY_DIV_ZERO, 0]
    assert count.tolist() == deg.tolist()
    # POLY_DIV_ZERO: the first root is exactly 0 and the later round is skipped.
    rre, rim, _, _ = F.find_roots_plain(torch.as_tensor(re_[8:9]), torch.as_tensor(im_[8:9]))
    assert rre[0, :2].tolist() == [0.0, 0.0] and rim[0, :2].tolist() == [0.0, 0.0]


def test_constants_mirror_cuda_source():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kN"), const("kMaxN"), const("kThreads"), const("kCapThreads")) == (
        F._N, F._MAX_N, F._THREADS, F._CAP_THREADS)
    assert F._MAX_N == 128  # LPC orders up to 127, voxtpu/ops/burg_pallas.py:87-88
    launches = re.findall(r"roots_kernel<T, (\w+), (true|false)><<<", src)
    assert launches == [("kN", "true"), ("kMaxN", "false")]
    assert STACK_CHECKED["roots_kernel"] == 2 * len(launches)  # float and double each


@pytest.mark.parametrize("shape", [(4, 0), (4, 33), (14,)])
def test_wrapper_rejects_shapes(shape):
    """(4, 0) and (14,) raise on either device. (4, 33) raised on either
    device while the kernel's capacity was 32: it now runs, and returns
    voxtpu's roots (the N = 33 rows of `roots_order_cases`) on the CPU, and
    the card takes it (the mirror of the capacity, 128, is checked against
    csrc/roots.cu above)."""
    if shape == (4, 33):
        re_, im_ = _case("N = 33", np.float64, roots_order_cases)
        assert re_.shape == shape and shape[1] <= F._MAX_N
        got = F.find_roots(torch.as_tensor(re_), torch.as_tensor(im_))
        want, wcount, wstatus = _jax_find_roots(jnp.asarray(re_), jnp.asarray(im_), backend="jnp")
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want.re), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want.im), rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(wcount))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(wstatus))
        return
    c = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        F.find_roots(c, c)


def test_wrapper_takes_any_order_on_cpu():
    """Above the card's 128 the CPU still runs the plain version, uncounted,
    as voxtpu's jnp path runs any order: a degree-10 polynomial under 118
    leading zeros (N = 129) gives the roots of its live part alone (N = 11)."""
    live = np.poly(0.6 * np.exp(1j * np.linspace(0.3, 2.8, 5)))
    live = np.poly(np.concatenate([np.roots(live), np.roots(live).conj()])).real[::-1]
    re_ = np.zeros((1, 129))
    re_[:, :11] = live
    before = F.find_roots.launches
    got = F.find_roots(torch.as_tensor(re_), torch.zeros((1, 129), dtype=torch.float64))
    assert F.find_roots.launches == before
    want = F.find_roots_plain(torch.as_tensor(re_[:, :11]), torch.zeros((1, 11), dtype=torch.float64))
    assert got[2].tolist() == [10] and got[3].tolist() == [0]
    np.testing.assert_allclose(got[0][:, :11].numpy(), want[0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1][:, :11].numpy(), want[1].numpy(), rtol=1e-12, atol=1e-12)
    assert not got[0][:, 11:].any() and not got[1][:, 11:].any()


def test_wrapper_rejects_mixed_dtypes_and_shapes():
    c = torch.ones((3, 14), dtype=torch.float64)
    with pytest.raises(TypeError):
        F.find_roots(c, c.float())
    with pytest.raises(ValueError):
        F.find_roots(c, c[:, :13])


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_runs_plain_uncounted_on_cpu(name):
    re_, im_ = (torch.as_tensor(x) for x in _case(name, np.float32))
    before = F.find_roots.launches
    got = F.find_roots(re_, im_)
    want = F.find_roots_plain(re_, im_)
    assert F.find_roots.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
