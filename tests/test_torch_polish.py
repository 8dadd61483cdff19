"""Kernel P, the float32 compensated-Newton root polish, on the CPU.

csrc/polish.cu runs on the card only (chip_smoke.py holds it to
`polish_roots_plain` bit for bit). Here, on LPC polynomials of the
two-vowels recording at CLI_DEFAULT_44K and on chip_smoke.py's
`polish_edge_cases` (zero, NaN and infinite root slots, an all-zero
polynomial, a lone top coefficient with under- and overflowing roots,
-0.0 coefficients):

- (a) `polish_roots_plain` equals the polish as it stood in
  voxtpu_torch.roots before it moved to ops/polish.py
  (`_pre_move_polish_roots`, kept verbatim below) bit for bit;
- (b) it agrees with voxtpu.roots.polish_roots at rtol/atol 1e-6 (the
  tolerance of tests/test_torch_formants.py's polish test), each edge row
  on its own, N in {2, 5, 14};
- (c) `_model_polish`, a per-slot scalar model in NumPy that follows
  csrc/polish.cu's operation order line for line (1 + iters Horner passes,
  each pass's value deciding the step before and its derivative giving the
  step after), equals it bit for bit: the CPU's only check of the
  kernel's order; and `_three_pass_polish`, the plain version with each
  point evaluated once as the kernel does, equals it bit for bit on
  random order-13 frames, the edge rows and N = 128, in both dtypes: the
  proof that the two passes the kernel drops change no bit;
- (d) the wrapper's argument checks, and no launch counted on the CPU;
- (e) the split constant, the register instantiation's N and the card's
  largest N, and every launcher's argument kinds mirror the CUDA sources.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voxtpu.cplx import C as JC
from voxtpu.roots import polish_roots as jax_polish_roots

from chip_smoke import polish_edge_cases
from voxtpu_torch import roots
from voxtpu_torch.cplx import C
from voxtpu_torch.frame import frame_signal
from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.ops import kernels, polish
from voxtpu_torch.ops.burg import burg_plain
from voxtpu_torch.ops.find_roots import find_roots_plain
from voxtpu_torch.pipeline import CLI_DEFAULT_44K
from voxtpu_torch.windows import hann

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "sample-two_vowels.wav")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "voxtpu_torch", "csrc")
EDGE_ROWS = ["zero slots", "NaN and inf slots", "all-zero polynomial", "lone top coefficient", "-0.0 coefficients"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def _two_vowels_lpc(frames: int, order: int, dt) -> tuple:
    """(c_re, c_im, z_re, z_im) as the formant stage builds them: Burg LPC of
    `frames` Hann-windowed frames spread over the recording, the reversed
    monic polynomial (N = order + 1) and its roots."""
    cfg = CLI_DEFAULT_44K
    x = torch.as_tensor(np.asarray(read_wav(FIX).samples, dtype=np.float64))
    fr = frame_signal(x, cfg.frame_len, cfg.hop)
    fr = fr[:: len(fr) // frames][:frames].to(dt) * torch.as_tensor(hann(cfg.frame_len), dtype=dt)
    coeffs, _ = burg_plain(fr, order)
    c_re = torch.cat([coeffs.flip(-1), torch.ones_like(coeffs[:, :1])], dim=-1).contiguous()
    c_im = torch.zeros_like(c_re)
    z_re, z_im, _, _ = find_roots_plain(c_re, c_im)
    return c_re, c_im, z_re, z_im


# ---- (a) the polish as it stood in voxtpu_torch/roots.py before the move


def _pm_two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _pm_quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


_PM_SPLIT = 4097.0


def _pm_two_prod(a, b):
    p = a * b
    ca = a * _PM_SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * _PM_SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _pm_df_add(x, y):
    s, e = _pm_two_sum(x[0], y[0])
    return _pm_quick_two_sum(s, e + x[1] + y[1])


def _pm_df_add_f(x, f):
    s, e = _pm_two_sum(x[0], f)
    return _pm_quick_two_sum(s, e + x[1])


def _pm_df_mul_f(x, f):
    p, e = _pm_two_prod(x[0], f)
    return _pm_quick_two_sum(p, e + x[1] * f)


def _pm_horner_df(c: C, zr, zi):
    N = c.re.shape[-1]
    zero = torch.zeros_like(zr)

    def coef(j):
        return c.re[..., j][..., None] + zero, c.im[..., j][..., None] + zero

    cr, ci = coef(N - 1)
    ar = (cr, zero)
    ai = (ci, zero)
    br, bi = zero, zero
    for j in range(N - 2, -1, -1):
        br, bi = br * zr - bi * zi + ar[0], br * zi + bi * zr + ai[0]
        re = _pm_df_add(_pm_df_mul_f(ar, zr), _pm_df_mul_f(ai, -zi))
        im = _pm_df_add(_pm_df_mul_f(ar, zi), _pm_df_mul_f(ai, zr))
        cr, ci = coef(j)
        ar = _pm_df_add_f(re, cr)
        ai = _pm_df_add_f(im, ci)
    return ar[0] + ar[1], ai[0] + ai[1], br, bi


def _pre_move_polish_roots(c: C, roots: C, iters: int = 2, max_step: float = 0.5) -> C:
    zr0, zi0 = roots.re, roots.im
    live = (zr0 != 0) | (zi0 != 0)
    pr, pi, _, _ = _pm_horner_df(c, zr0, zi0)
    best_r, best_i = zr0, zi0
    best_n = pr * pr + pi * pi
    cur_r, cur_i = zr0, zi0
    ms2 = max_step * max_step
    for _ in range(iters):
        pr, pi, dpr, dpi = _pm_horner_df(c, cur_r, cur_i)
        den = dpr * dpr + dpi * dpi
        dzr = (pr * dpr + pi * dpi) / den
        dzi = (pi * dpr - pr * dpi) / den
        ok = torch.isfinite(dzr) & torch.isfinite(dzi) & (dzr * dzr + dzi * dzi <= ms2)
        cur_r = torch.where(ok, cur_r - dzr, cur_r)
        cur_i = torch.where(ok, cur_i - dzi, cur_i)
        prn, pin_, _, _ = _pm_horner_df(c, cur_r, cur_i)
        n_new = prn * prn + pin_ * pin_
        better = n_new < best_n  # False for NaN
        best_r = torch.where(better, cur_r, best_r)
        best_i = torch.where(better, cur_i, best_i)
        best_n = torch.where(better, n_new, best_n)
    return C(torch.where(live, best_r, zr0), torch.where(live, best_i, zi0))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["two-vowels LPC", "edge rows"])
def test_plain_equals_pre_move_polish(case, dt):
    args = _two_vowels_lpc(24, 13, dt)
    if case == "edge rows":
        args = polish_edge_cases(*args)
    c_re, c_im, z_re, z_im = args
    got = polish.polish_roots_plain(*args)
    want = _pre_move_polish_roots(C(c_re, c_im), C(z_re, z_im))
    assert torch.equal(_bits(got[0]), _bits(want.re)) and torch.equal(_bits(got[1]), _bits(want.im))
    # through voxtpu_torch.roots, with a leading batch axis
    via = roots.polish_roots(C(c_re.reshape(2, 12, 14), c_im.reshape(2, 12, 14)),
                             C(z_re.reshape(2, 12, 14), z_im.reshape(2, 12, 14)))
    assert torch.equal(_bits(via.re.reshape(24, 14)), _bits(got[0]))
    assert torch.equal(_bits(via.im.reshape(24, 14)), _bits(got[1]))
    if case == "two-vowels LPC":  # the polish moves the roots
        assert int((got[0] != z_re).sum()) > z_re.numel() // 2


# ---- (b) against voxtpu's jnp polish


@pytest.fixture(scope="module", params=[2, 5, 14], ids=lambda n: f"N={n}")
def against_jax(request):
    """The edge rows and three plain LPC rows at N, in float32: the port's
    polish and voxtpu's, as numpy arrays."""
    N = request.param
    args = polish_edge_cases(*_two_vowels_lpc(8, N - 1, torch.float32), rows=8)
    got = polish.polish_roots_plain(*args)
    c_re, c_im, z_re, z_im = (jnp.asarray(t.numpy()) for t in args)
    want = jax_polish_roots(JC(c_re, c_im), JC(z_re, z_im))
    return [t.numpy() for t in got], [np.asarray(want.re), np.asarray(want.im)]


@pytest.mark.parametrize("row", EDGE_ROWS + ["plain LPC rows"])
def test_plain_matches_jax_polish(against_jax, row):
    rows = slice(5, None) if row == "plain LPC rows" else EDGE_ROWS.index(row)
    got, want = against_jax
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[rows], w[rows], rtol=1e-6, atol=1e-6)


# ---- (c) the kernel's operation order, one slot at a time


def _model_polish(c_re, c_im, z_re, z_im, iters=2, max_step=0.5):
    """csrc/polish.cu's polish_kernel, line for line, over every slot of
    (F, N) NumPy arrays, in their dtype T."""
    T = c_re.dtype.type
    split = T(4097.0)  # kSplit
    ms2 = T(max_step * max_step)

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def quick_two_sum(a, b):
        s = a + b
        return s, b - (s - a)

    def two_prod(a, b):
        p = a * b
        ca = a * split
        ah = ca - (ca - a)
        al = a - ah
        cb = b * split
        bh = cb - (cb - b)
        bl = b - bh
        return p, ((((ah * bh) - p) + (ah * bl)) + (al * bh)) + (al * bl)

    def df_add(x, y):
        s = two_sum(x[0], y[0])
        return quick_two_sum(s[0], (s[1] + x[1]) + y[1])

    def df_add_f(x, f):
        s = two_sum(x[0], f)
        return quick_two_sum(s[0], s[1] + x[1])

    def df_mul_f(x, f):
        p = two_prod(x[0], f)
        return quick_two_sum(p[0], p[1] + (x[1] * f))

    def horner_df(cre, cim, zr, zi):
        zero = T(0)
        N = len(cre)
        ar = (cre[N - 1] + zero, zero)
        ai = (cim[N - 1] + zero, zero)
        br, bi = zero, zero
        for j in range(N - 2, -1, -1):
            nbr = ((br * zr) - (bi * zi)) + ar[0]
            nbi = ((br * zi) + (bi * zr)) + ai[0]
            br, bi = nbr, nbi
            nzi = -zi
            re = df_add(df_mul_f(ar, zr), df_mul_f(ai, nzi))
            im = df_add(df_mul_f(ar, zi), df_mul_f(ai, zr))
            cr = cre[j] + zero
            ci = cim[j] + zero
            ar = df_add_f(re, cr)
            ai = df_add_f(im, ci)
        return ar[0] + ar[1], ai[0] + ai[1], br, bi

    out_re, out_im = z_re.copy(), z_im.copy()
    for row, slot in np.ndindex(*z_re.shape):
        cre, cim = c_re[row], c_im[row]
        zr0, zi0 = z_re[row, slot], z_im[row, slot]
        if not (zr0 != T(0) or zi0 != T(0)):
            continue
        pr, pi, dpr, dpi = horner_df(cre, cim, zr0, zi0)
        best_r, best_i = zr0, zi0
        best_n = (pr * pr) + (pi * pi)
        cur_r, cur_i = zr0, zi0
        for _ in range(iters):
            # p(cur) and p'(cur): the last pass was at cur
            den = (dpr * dpr) + (dpi * dpi)
            dzr = ((pr * dpr) + (pi * dpi)) / den
            dzi = ((pi * dpr) - (pr * dpi)) / den
            if np.isfinite(dzr) and np.isfinite(dzi) and ((dzr * dzr) + (dzi * dzi) <= ms2):
                cur_r = cur_r - dzr
                cur_i = cur_i - dzi
            pr, pi, dpr, dpi = horner_df(cre, cim, cur_r, cur_i)
            n_new = (pr * pr) + (pi * pi)
            if n_new < best_n:
                best_r, best_i, best_n = cur_r, cur_i, n_new
        out_re[row, slot], out_im[row, slot] = best_r, best_i
    return out_re, out_im


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_kernel_order_model_equals_plain(dt):
    """42 slots: two LPC frames at N = 14 and the five edge rows at N = 3."""
    cases = [_two_vowels_lpc(2, 13, dt), polish_edge_cases(*_two_vowels_lpc(5, 2, dt), rows=5)]
    for args, max_step in zip(cases, (0.5, 0.3)):
        got = polish.polish_roots_plain(*args, max_step=max_step)
        with np.errstate(all="ignore"):
            model = _model_polish(*(t.numpy() for t in args), max_step=max_step)
        for g, m in zip(got, model):
            assert torch.equal(_bits(g), _bits(torch.from_numpy(m)))


def _three_pass_polish(c_re, c_im, z_re, z_im, iters=2, max_step=0.5):
    """`polish.polish_roots_plain` with each point evaluated once: the pass
    at z0 also gives the first step, and each pass after a step also gives
    the next step (the plain version evaluates that point twice)."""
    zr0, zi0 = z_re, z_im
    live = (zr0 != 0) | (zi0 != 0)
    pr, pi, dpr, dpi = polish._horner_df(c_re, c_im, zr0, zi0)
    best_r, best_i = zr0, zi0
    best_n = pr * pr + pi * pi
    cur_r, cur_i = zr0, zi0
    ms2 = max_step * max_step
    for _ in range(iters):
        den = dpr * dpr + dpi * dpi
        dzr = (pr * dpr + pi * dpi) / den
        dzi = (pi * dpr - pr * dpi) / den
        ok = torch.isfinite(dzr) & torch.isfinite(dzi) & (dzr * dzr + dzi * dzi <= ms2)
        cur_r = torch.where(ok, cur_r - dzr, cur_r)
        cur_i = torch.where(ok, cur_i - dzi, cur_i)
        pr, pi, dpr, dpi = polish._horner_df(c_re, c_im, cur_r, cur_i)
        n_new = pr * pr + pi * pi
        better = n_new < best_n
        best_r = torch.where(better, cur_r, best_r)
        best_i = torch.where(better, cur_i, best_i)
        best_n = torch.where(better, n_new, best_n)
    return torch.where(live, best_r, zr0), torch.where(live, best_i, zi0)


def _random_lpc(frames: int, order: int, dt, seed: int) -> tuple:
    """(c_re, c_im, z_re, z_im): Burg LPC of seeded noise frames, 512
    samples each, their reversed monic polynomials (N = order + 1) and
    roots."""
    x = np.random.default_rng(seed).standard_normal((frames, 512)) * hann(512)
    coeffs, _ = burg_plain(torch.as_tensor(x, dtype=dt), order)
    c_re = torch.cat([coeffs.flip(-1), torch.ones_like(coeffs[:, :1])], dim=-1).contiguous()
    c_im = torch.zeros_like(c_re)
    z_re, z_im, _, _ = find_roots_plain(c_re, c_im)
    return c_re, c_im, z_re, z_im


def _n128(dt) -> tuple:
    """N = 128: two rows of 127 roots spread near the circle (no root finder
    needed: the roots are the polish's start) and their real polynomial, and
    the zero, NaN and infinite slots of the edge rows."""
    rng = np.random.default_rng(3)
    rows_c, rows_z = [], []
    for _ in range(2):
        ang = np.pi * (np.arange(63) + 0.5) / 63 + rng.uniform(-0.01, 0.01, 63)
        r = 0.9 * np.exp(1j * ang)
        roots = np.concatenate([r, r.conj(), [0.8]])
        rows_c.append(np.poly(roots).real[::-1])
        rows_z.append(roots * (1 + 1e-4 * rng.standard_normal(127)))
    c_re = torch.as_tensor(np.stack(rows_c), dtype=dt)
    z = np.concatenate([np.stack(rows_z), np.zeros((2, 1))], axis=1)
    z_re = torch.as_tensor(z.real, dtype=dt)
    z_im = torch.as_tensor(z.imag, dtype=dt)
    z_re[1, 5], z_re[1, 6], z_im[1, 7] = float("nan"), float("inf"), -0.0
    return c_re.contiguous(), torch.zeros_like(c_re), z_re.contiguous(), z_im.contiguous()


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["two-vowels LPC, order 13", "random LPC, order 13", "edge rows", "N = 128"])
def test_three_passes_equal_plain(case, dt):
    if case == "two-vowels LPC, order 13":
        args = _two_vowels_lpc(64, 13, dt)
    elif case == "random LPC, order 13":
        args = _random_lpc(64, 13, dt, seed=5)
    elif case == "edge rows":
        args = polish_edge_cases(*_random_lpc(8, 13, dt, seed=6), rows=8)
    else:
        args = _n128(dt)
    for iters, max_step in ((2, 0.5), (1, 0.5), (3, 0.3), (0, 0.5)):
        got = _three_pass_polish(*args, iters=iters, max_step=max_step)
        with np.errstate(all="ignore"):
            want = polish.polish_roots_plain(*args, iters=iters, max_step=max_step)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w)), (case, iters)


# ---- (d) the wrapper


def _bad_args(kind):
    c_re, c_im, z_re, z_im = _two_vowels_lpc(2, 4, torch.float32)
    if kind == "mixed devices":
        return (c_re.to("meta"), c_im, z_re, z_im), ValueError
    if kind == "roots narrower than coefficients":
        return (c_re, c_im, z_re[:, :-1], z_im[:, :-1]), ValueError
    if kind == "one-dimensional":
        return (c_re[0], c_im[0], z_re[0], z_im[0]), ValueError
    return (c_re, c_im, z_re.double(), z_im.double()), TypeError


@pytest.mark.parametrize("kind", ["mixed devices", "roots narrower than coefficients", "one-dimensional",
                                  "mixed dtypes"])
def test_wrapper_rejects(kind):
    args, err = _bad_args(kind)
    with pytest.raises(err, match="polish_roots|device"):
        polish.polish_roots(*args)


def test_wrapper_runs_plain_on_cpu_uncounted():
    args = _two_vowels_lpc(3, 13, torch.float32)
    polish.polish_roots.launches = 0
    got = polish.polish_roots(*args)
    want = polish.polish_roots_plain(*args)
    assert polish.polish_roots.launches == 0
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="must match"):
        roots.polish_roots(C(args[0], args[1]), C(args[2][:, :5], args[3][:, :5]))


# ---- (e) the CUDA sources


def test_split_constant_mirrors_the_cuda_source():
    with open(os.path.join(CSRC, "polish.cu")) as f:
        src = f.read()
    m = re.search(r"constexpr double kSplit = ([0-9.]+);", src)
    assert m and float(m.group(1)) == polish._SPLIT == 4097.0
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("kN", "kMaxN")}
    assert (const["kN"], const["kMaxN"]) == (polish._N, polish._MAX_N) == (14, 128)


_KINDS = {"const void*": "p", "void*": "p", "int": "i", "double": "d"}


@pytest.mark.parametrize("symbol", sorted(kernels._SIGNATURES))
def test_launcher_signature_mirrors_the_cuda_source(symbol):
    """Every exported instantiation (both dtypes, or float32 alone where
    `kernels.suffixes` says so) takes the argument kinds that
    `kernels.library()` binds, then the stream; no other is exported."""
    sources = "".join(open(os.path.join(CSRC, f)).read() for f in sorted(os.listdir(CSRC)) if f.endswith(".cu"))
    exported = set(re.findall(rf"VT_EXPORT int {symbol}_(f\d\d)\(", sources))
    assert exported == set(kernels.suffixes(symbol))
    for suffix in kernels.suffixes(symbol):
        m = re.search(rf"VT_EXPORT int {symbol}_{suffix}\(([^)]*)\)", sources)
        assert m, f"{symbol}_{suffix} not exported"
        params = [re.sub(r"\s*\w+$", "", p.strip()) for p in m.group(1).split(",")]
        assert params[-1] == "void*"  # the stream
        assert "".join(_KINDS[p] for p in params[:-1]) == kernels._SIGNATURES[symbol]
