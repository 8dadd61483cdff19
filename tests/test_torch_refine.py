"""Kernel A's order of operations (csrc/refine.cu) modelled in NumPy and
held to `refine_plain` on the CPU, and what `stats` counts.

The kernel runs one warp a candidate: lane l sums taps l, l + 32, ... of
each side in ascending order, a butterfly of 5 xor shuffles adds the 32
partial sums, and every lane then holds the same bits and runs the same
Brent step. `_model_refine` follows those steps in the working dtype. It is
held to `refine_plain` at the tolerances `tests/test_torch_pitch.py` holds
`refine_plain` to voxtpu (float64: Brent's own tolerance; float32: the f32
fuzz test's bracket), on lag rows of the bundled recording at the CLI
default's and the bench's offsets. The sums are the only numbers the
kernel forms in another order than the plain version.
"""

import math
import os

import numpy as np
import pytest
import torch

from voxtpu_torch import sinc
from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.ops.refine import _GOLDEN, refine, refine_plain
from voxtpu_torch.pitch import REFINE_SINC_DEPTH, lag_candidates
from voxtpu_torch.windows import hann

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sample-two_vowels.wav")
LANES = 32  # csrc/refine.cu: a warp's lanes share one candidate's taps
# Frame length and hop: the CLI default at 44.1 kHz (offset -1,103) and the
# bench's 4096-sample frames (offset -2,049).
SHAPES = {"cli": (2205, 441), "bench": (4096, 1024)}
ROWS = 6  # frames a case, spread over the recording


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refine_args(shape: str, dt: torch.dtype, rows: int = ROWS) -> tuple:
    """Kernel A's arguments as the pitch stage passes them, for `rows` frames
    of the bundled recording (60-600 Hz, 32 candidates)."""
    wav = read_wav(FIXTURE)
    n, hop = SHAPES[shape]
    x = np.asarray(wav.samples, dtype=np.float64)
    starts = np.linspace(20, (len(x) - n) // hop - 20, rows).astype(int) * hop
    frames = torch.as_tensor(np.stack([x[s : s + n] for s in starts]) * hann(n), dtype=dt)
    lc = lag_candidates(frames, float(wav.sample_rate), 60.0, 600.0, 32)
    T = sinc._max_effective_depth(lc.offset, lc.nx, REFINE_SINC_DEPTH, lc.max_x + 1.0)
    return lc.self_lag, lc.pos, lc.valid, lc.offset, REFINE_SINC_DEPTH, T


def _warp_sum(prods: np.ndarray) -> np.ndarray:
    """The kernel's sum of one side's products: per lane in ascending tap
    order, then the xor butterfly; every lane ends with the same bits."""
    steps = -(-len(prods) // LANES)
    padded = np.zeros(steps * LANES, prods.dtype)
    padded[: len(prods)] = prods  # + 0.0 leaves a partial sum as it is
    acc = np.zeros(LANES, prods.dtype)
    for k in range(steps):
        acc = acc + padded[k * LANES : (k + 1) * LANES]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(LANES) ^ off]
    assert np.all(acc.view(np.uint8).reshape(LANES, -1) == acc[:1].view(np.uint8))
    return acc[0]


def _model_eval(y, offset, max_depth, T, K, x):
    """SincEval::operator() at x for a candidate with floor(x0) = K: the
    interpolant and the clipped depth md."""
    dt = y.dtype.type
    L = len(y)
    pi = dt(math.pi)
    nl = np.floor(x)
    nl_i = int(nl)
    s = min(max(nl_i - K, -1), 1)
    phil = x - nl
    phir = dt(1) - phil
    md = min(max(offset + nl_i + 1, 0), max_depth, T)
    base = offset + K + s
    n = np.arange(md + 1)
    tap = n.astype(dt)
    sign = np.where(n % 2 == 1, dt(-1), dt(1))

    def side(phi, idx):
        a = pi * (phi + tap)
        coef = (np.sin(pi * phi) * sign / a) * (dt(0.5) + dt(0.5) * np.cos(a / (phi + dt(md))))
        return _warp_sum(y[np.clip(idx, 0, L - 1)] * coef)

    with np.errstate(invalid="ignore", divide="ignore"):
        result = side(phil, base + 1 - n) + side(phir, base + n)
    if abs(x - (nl + dt(1))) < dt(1e-10):
        result = y[min(max(base + 1, 0), L - 1)]
    if abs(x - nl) < dt(1e-10):
        result = y[min(max(base, 0), L - 1)]
    return result, md


def _model_refine(y, x0, valid, offset, max_depth, T, iters=60, tol=1e-10):
    """refine_kernel in NumPy, one candidate at a time: (x, f(x), stats)."""
    dt = y.dtype.type
    eps = dt(np.finfo(dt).eps)
    sqrt_eps = dt(math.sqrt(float(np.finfo(dt).eps)))
    tol3 = dt(tol / 3.0)
    golden = dt(_GOLDEN)
    B, C = x0.shape
    x_out, fx_out = np.empty_like(x0), np.empty_like(x0)
    evals = tap_sides = most = 0
    for r in range(B):
        for c in range(C):
            xs, live = x0[r, c], bool(valid[r, c])
            K = int(np.floor(xs))

            def f(x):
                return _model_eval(y[r], offset, max_depth, T, K, x)

            if iters == 0:
                x, (fx, md) = xs, f(xs)
                evals += live
                tap_sides += live * 2 * (md + 1)
            else:
                a, b = xs - dt(1), xs + dt(1)
                v = a + golden * (b - a)
                fv, md = f(v)
                x = w = v
                fx = fw = fv
                if live:
                    evals += 1
                    tap_sides += 2 * (md + 1)
                    it = 0
                    while it < iters:
                        rng = b - a
                        middle = (a + b) * dt(0.5)
                        tol_act = sqrt_eps * abs(x) + tol3
                        if abs(x - middle) + rng * dt(0.5) <= dt(2) * tol_act:
                            break
                        new_step = golden * (b - x) if x < middle else golden * (a - x)
                        t_ = (x - w) * (fx - fv)
                        q = (x - v) * (fx - fw)
                        p = (x - v) * q - (x - w) * t_
                        q = dt(2) * q - t_
                        if q > dt(0):
                            p = -p
                        else:
                            q = -q
                        if (abs(x - w) >= tol_act and abs(p) < abs(new_step * q)
                                and p > q * (a - x + dt(2) * tol_act) and p < q * (b - x - dt(2) * tol_act)):
                            new_step = p / (dt(1) if q == dt(0) else q)
                        if abs(new_step) < tol_act:
                            new_step = tol_act if new_step > dt(0) else -tol_act
                        t = x + new_step
                        ft, md = f(t)
                        tap_sides += 2 * (md + 1)
                        it += 1
                        if ft <= fx:
                            if t < x:
                                b = x
                            else:
                                a = x
                            v, fv, w, fw, x, fx = w, fw, x, fx, t, ft
                        else:
                            if t < x:
                                a = t
                            else:
                                b = t
                            if ft <= fw or abs(w - x) < eps:
                                v, fv, w, fw = w, fw, t, ft
                            elif ft <= fv or abs(v - x) < eps or abs(v - w) < eps:
                                v, fv = t, ft
                    evals += it
                    most = max(most, it)
            x_out[r, c], fx_out[r, c] = x, fx
    return x_out, fx_out, (evals, tap_sides, most)


def _numpy(args):
    y, x0, valid = (t.numpy() for t in args[:3])
    return (y, x0, valid, *args[3:])


def _plain_stats(args, **kw):
    st = torch.zeros(3, dtype=torch.int64)
    x, fx = refine_plain(*args, stats=st, **kw)
    return x.numpy(), fx.numpy(), tuple(int(v) for v in st)


def _assert_close(dt, x, fx, xp, fp, valid):
    if dt == torch.float64:
        np.testing.assert_allclose(x[valid], xp[valid], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(fx[valid], fp[valid], rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(x[valid], xp[valid], atol=0.2)
        np.testing.assert_allclose(fx[valid], fp[valid], rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_matches_plain(shape, dt):
    args = _refine_args(shape, dt)
    assert args[3] == {"cli": -1103, "bench": -2049}[shape]
    x, fx, st = _model_refine(*_numpy(args))
    xp, fp, stp = _plain_stats(args)
    valid = args[2].numpy()
    assert valid.sum() >= 3 * ROWS
    _assert_close(dt, x, fx, xp, fp, valid)
    # Masked-off lanes return (v0, f(v0)); their f agrees as a live lane's.
    np.testing.assert_allclose(fx[~valid], fp[~valid], rtol=1e-3 if dt == torch.float32 else 1e-10, atol=1e-7)
    # The same Brent trajectories, to within a lane or two that a last-ulp
    # difference in a sum sends one step further.
    assert abs(st[0] - stp[0]) <= 0.005 * stp[0] + 2
    assert abs(st[1] - stp[1]) <= 0.005 * stp[1] + 2 * 739


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_model_eval_only_matches_plain_with_snap(dt):
    """iters=0 at depth 1200 and 30; one start is an exact integer, which
    takes the integer-snap branch (the row's value there)."""
    y, x0, valid, offset, _, T = _refine_args("cli", dt)
    x0 = x0.clone()
    r, c = 1, 0
    x0[r, c] = torch.floor(x0[r, c])
    for depth in (REFINE_SINC_DEPTH, 30):
        args = (y, x0, valid, offset, depth, T)
        x, fx, st = _model_refine(*_numpy(args), iters=0)
        xp, fp, stp = _plain_stats(args, iters=0)
        np.testing.assert_array_equal(x, x0.numpy())
        np.testing.assert_array_equal(xp, x0.numpy())
        tol = dict(rtol=1e-10, atol=1e-12) if dt == torch.float64 else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fx, fp, **tol)
        assert fx[r, c] == fp[r, c] == float(y[r, int(x0[r, c]) + offset])
        assert st == stp and st[0] == int(valid.sum()) and st[2] == 0


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_model_is_batch_invariant(dt):
    """A row's outputs are the same bits alone, in its batch and in a
    permuted batch: a candidate's sums depend on its own md alone."""
    y, x0, valid, offset, depth, T = _numpy(_refine_args("cli", dt, rows=3))
    y, x0, valid = y, x0[:, :12], valid[:, :12]
    x, fx, _ = _model_refine(y, x0, valid, offset, depth, T)
    perm = np.array([2, 0, 1])
    xq, fq, _ = _model_refine(y[perm], x0[perm], valid[perm], offset, depth, T)
    xa, fa, _ = _model_refine(y[1:2], x0[1:2], valid[1:2], offset, depth, T)
    bits = np.uint32 if dt == torch.float32 else np.uint64
    for got, want in ((xq, x[perm]), (fq, fx[perm]), (xa, x[1:2]), (fa, fx[1:2])):
        np.testing.assert_array_equal(got.view(bits), want.view(bits))


def test_plain_stats_f32_brent_stops_after_two_evaluations():
    """At the CLI offset float32 Brent's stop test, tol_act = sqrt(eps)|x|
    with |x| ~ 1,500, is ~0.5 samples: at most 2 evaluations a live lane.
    Float64 takes many more."""
    args32 = _refine_args("cli", torch.float32)
    live = int(args32[2].sum())
    _, _, (evals, taps, most) = _plain_stats(args32)
    assert live <= evals <= 2 * live and most <= 1
    assert 2 * live <= taps <= evals * 2 * (args32[5] + 1)
    _, _, (evals64, _, most64) = _plain_stats(_refine_args("cli", torch.float64))
    assert evals64 > 10 * live and most64 > 10


def test_plain_stats_count_tap_sides_of_live_lanes():
    """Evaluation-only mode: one evaluation a live lane of 2 (md + 1)
    tap-sides, md the reference's clipped depth at floor(x0); masked-off
    lanes are not counted. The wrapper hands CPU tensors' stats to the plain
    version."""
    y, x0, valid, offset, depth, T = _refine_args("bench", torch.float64, rows=2)
    md = torch.clamp(offset + torch.floor(x0).long() + 1, min=0).clamp(max=min(depth, T))
    _, _, st = _plain_stats((y, x0, valid, offset, depth, T), iters=0)
    assert st == (int(valid.sum()), int((2 * (md + 1))[valid].sum()), 0)
    got = torch.full((3,), -1, dtype=torch.int64)
    refine(y, x0, valid, offset, depth, T, iters=0, stats=got)
    assert tuple(int(v) for v in got) == st


@pytest.mark.parametrize("bad", [torch.zeros(3, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)])
def test_stats_must_be_three_int64(bad):
    y, x0, valid, offset, depth, T = _refine_args("cli", torch.float64, rows=1)
    with pytest.raises(ValueError, match="stats"):
        refine(y, x0, valid, offset, depth, T, stats=bad)
