"""The frame-local stages of the analysis, in plain PyTorch.

A frozen, rewritten copy of the plain versions of `voxtpu_torch`'s stages,
for the benchmark's check: Hann window and RMS, the quirked FFT
autocorrelation (vox_box periodic.rs:276-289), the pitch pre-stage
(normalise, lag window, 3-point maxima, parabolic frequency, band filter),
the first candidates in lag order, Brent over the depth-1200 windowed sinc
(periodic.rs:29-230), the unvoiced candidate and the sort by strength; Burg
LPC (spectrum.rs:101-146), Laguerre roots with deflation
(polynomial.rs:34-195), the float32 compensated-Newton polish, resonances
and their packing (spectrum.rs:149-210, lib.rs:40-111); the MFCC
filterbank and DCT (spectrum.rs:371-441). Nothing here imports the port.

Every function takes frames in the dtype it computes in. `rnd`, where a
function takes it, is applied to each stage's result before the next stage
reads it: the identity for the reference, a rounding to TF32 for the
control (`benchmark.reference.analysis.tf32`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

LPC_DENUM_NONPOS = 1 << 0
POLY_ZERO_DEGREE = 1 << 1
POLY_DIV_ZERO = 1 << 2
NONFINITE_INPUT = 1 << 4

INTERPOLATION_DEPTH = 0.5  # periodic.rs:413
REFINE_SINC_DEPTH = 1200  # periodic.rs:444
NSLOTS = 6  # spectrum.rs:228
MAX_RESONANCES = 32  # lib.rs:26
_GOLDEN = 1.0 - 0.6180339887498948482045868343656381177203091798057628621
# Lanes x taps a chunk of the Brent search gathers at once.
_CHUNK_ELEMS = 1 << 27


def _same(x):
    return x


# --- tables -----------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def hann(n: int) -> np.ndarray:
    phase = np.arange(n, dtype=np.float64) / n
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * phase)


@functools.lru_cache(maxsize=8)
def hanning_lag(n: int) -> np.ndarray:
    phase = np.arange(n, dtype=np.float64) / n
    v = 2.0 * np.pi * phase
    return (1.0 - phase) * (2.0 / 3.0 + np.cos(v) / 3.0) + np.sin(v) / (2.0 * np.pi)


def _table(make, n, like):
    return torch.as_tensor(make(n), dtype=like.dtype, device=like.device)


# --- pitch ------------------------------------------------------------------

def autocorrelate(x: torch.Tensor) -> torch.Tensor:
    """r[lag] = AC_true[lag] - x[0] x[lag] + x[0] (the reference seeds its
    accumulator with x[0] and skips the i = 0 term)."""
    n = x.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    power = (spec.real.square() + spec.imag.square()).to(x.dtype)
    ac = torch.fft.irfft(power, n=nfft, dim=-1)[..., :n].to(x.dtype)
    x0 = x[..., :1]
    return ac - x0 * x + x0


def pitch_pre(ac, bi: int, sample_rate: float, fmin: float, fmax: float):
    """(self_lag (B, 2n), freq (B, bi), cand (B, bi)): the lags normalised,
    divided by the Hann lag window, non-finite rows zeroed, zero-padded to
    2n; strict 3-point maxima at lags 1..bi-2 inside the band."""
    B, n = ac.shape
    self_lag = ac / torch.amax(torch.abs(ac), dim=-1, keepdim=True)
    self_lag = self_lag / _table(hanning_lag, n, ac)
    self_lag = torch.where(torch.isfinite(self_lag), self_lag, 0.0)
    self_lag = torch.cat([self_lag, torch.zeros_like(self_lag)], dim=-1).contiguous()
    seg = self_lag[:, :bi]
    peak, rev, fwd = seg[:, 1:-1], seg[:, :-2], seg[:, 2:]
    is_max = (rev < peak) & (fwd < peak)
    ix = torch.arange(1, bi - 1, device=ac.device)
    dr = 0.5 * (fwd - rev)
    d2r = 2.0 * peak - (rev - fwd)  # sic: periodic.rs:424
    f = sample_rate / (ix.to(ac.dtype)[None, :] + dr / d2r)
    c = is_max & ((f == 0.0) | ((f > fmin) & (f < fmax)))
    freq = torch.zeros((B, bi), dtype=ac.dtype, device=ac.device)
    cand = torch.zeros((B, bi), dtype=torch.bool, device=ac.device)
    freq[:, 1 : bi - 1] = torch.where(c, f, 0.0)
    cand[:, 1 : bi - 1] = c
    return self_lag, freq, cand


def _max_effective_depth(offset: int, max_depth: int, max_x: float) -> int:
    on_max = offset + int(math.floor(max_x)) + 1
    return min(max_depth, max(on_max + 1, 0))


def _clipped_depth(nl_i, offset, max_depth, T):
    md = torch.clamp(offset + nl_i + 1, min=0)
    return torch.clamp(md, max=min(int(max_depth), int(T)))


def _gather(y, idx):
    B, L = y.shape
    idx = torch.clamp(idx, 0, L - 1)
    return torch.gather(y, 1, idx.reshape(B, -1)).reshape(idx.shape)


class _Sinc:
    """The windowed-sinc interpolant of lag rows y (B, L) near fixed starts
    x0 (B, C): during Brent floor(x) - floor(x0) stays in {-1, 0, 1}."""

    def __init__(self, y, offset: int, x0, max_depth: int, T: int):
        self.y, self.offset, self.max_depth, self.T = y, offset, max_depth, T
        self.K = torch.floor(x0).long()
        self.n = torch.arange(T + 1, device=y.device)
        self.tap = self.n.to(y.dtype)
        self.sign = (1 - 2 * (self.n % 2)).to(y.dtype)

    def _coefs(self, phi, md):
        a = math.pi * (phi[..., None] + self.tap)
        coef = (torch.sin(math.pi * phi)[..., None] * self.sign / a) * (
            0.5 + 0.5 * torch.cos(a / (phi + md.to(phi.dtype))[..., None])
        )
        return torch.where(self.n <= md[..., None], coef, torch.zeros_like(coef))

    def __call__(self, x):
        nl = torch.floor(x)
        nl_i = nl.long()
        s = torch.clamp(nl_i - self.K, -1, 1)
        phil = x - nl
        md = _clipped_depth(nl_i, self.offset, self.max_depth, self.T)
        base = self.offset + self.K + s
        lsum = torch.sum(_gather(self.y, base[..., None] + 1 - self.n) * self._coefs(phil, md), dim=-1)
        rsum = torch.sum(_gather(self.y, base[..., None] + self.n) * self._coefs(1.0 - phil, md), dim=-1)
        result = lsum + rsum
        result = torch.where(torch.abs(x - (nl + 1.0)) < 1e-10, _gather(self.y, base + 1), result)
        return torch.where(torch.abs(x - nl) < 1e-10, _gather(self.y, base), result)


def _brent(f, x0, valid, iters: int = 60, tol: float = 1e-10):
    """brent_maximize (periodic.rs:103-188) over lanes, masked updates."""
    eps = torch.finfo(x0.dtype).eps
    sqrt_eps = math.sqrt(eps)
    a, b = x0 - 1.0, x0 + 1.0
    v = a + _GOLDEN * (b - a)
    fv = f(v)
    x, w, fx, fw = v, v, fv, fv
    done = ~valid
    for _ in range(iters):
        if bool(done.all()):
            break
        middle = (a + b) * 0.5
        tol_act = sqrt_eps * torch.abs(x) + tol / 3.0
        done = done | (torch.abs(x - middle) + (b - a) * 0.5 <= 2.0 * tol_act)
        new_step = torch.where(x < middle, _GOLDEN * (b - x), _GOLDEN * (a - x))
        t_ = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * t_
        q = 2.0 * q - t_  # sic (periodic.rs:140)
        p = torch.where(q > 0.0, -p, p)
        q = torch.where(q > 0.0, q, -q)
        para = ((torch.abs(x - w) >= tol_act) & (torch.abs(p) < torch.abs(new_step * q))
                & (p > q * (a - x + 2.0 * tol_act)) & (p < q * (b - x - 2.0 * tol_act)))
        new_step = torch.where(para, p / torch.where(q == 0.0, 1.0, q), new_step)
        new_step = torch.where(torch.abs(new_step) < tol_act, torch.where(new_step > 0.0, tol_act, -tol_act),
                               new_step)
        t = x + new_step
        ft = f(t)
        better = ft <= fx
        keep_w = (ft <= fw) | (torch.abs(w - x) < eps)
        keep_v = (ft <= fv) | (torch.abs(v - x) < eps) | (torch.abs(v - w) < eps)
        na = torch.where(better, torch.where(t < x, a, x), torch.where(t < x, t, a))
        nb = torch.where(better, torch.where(t < x, x, b), torch.where(t < x, b, t))
        nv = torch.where(better, w, torch.where(keep_w, w, torch.where(keep_v, t, v)))
        nfv = torch.where(better, fw, torch.where(keep_w, fw, torch.where(keep_v, ft, fv)))
        nw = torch.where(better, x, torch.where(keep_w, t, w))
        nfw = torch.where(better, fx, torch.where(keep_w, ft, fw))
        nx = torch.where(better, t, x)
        nfx = torch.where(better, ft, fx)
        upd = ~done
        a, b = torch.where(upd, na, a), torch.where(upd, nb, b)
        x, w, v = torch.where(upd, nx, x), torch.where(upd, nw, w), torch.where(upd, nv, v)
        fx, fw, fv = torch.where(upd, nfx, fx), torch.where(upd, nfw, fw), torch.where(upd, nfv, fv)
    return x, fx


def refine(y, x0, valid, offset: int, max_depth: int, T: int):
    """Brent over the sinc interpolant of each row of y at every lane of x0
    (B, C), in chunks of rows (lanes are independent)."""
    B, C = x0.shape
    rows = max(1, _CHUNK_ELEMS // max(1, C * (T + 1)))
    xs, fs = [], []
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        x, fx = _brent(_Sinc(y[sl], offset, x0[sl], max_depth, T), x0[sl], valid[sl])
        xs.append(x)
        fs.append(fx)
    return torch.cat(xs), torch.cat(fs)


def pitch_candidates(windowed, sample_rate: float, threshold: float, fmin: float, fmax: float,
                     max_candidates: int, rnd=_same):
    """(freq, strength, valid), each (B, max_candidates + 1), sorted by
    strength descending, from (B, n) Hann-windowed frames."""
    B, n = windowed.shape
    dt, dev = windowed.dtype, windowed.device
    bi = int(math.floor(INTERPOLATION_DEPTH * n))
    C = min(max_candidates, bi - 2)
    self_lag, freq_l, cand_l = pitch_pre(rnd(autocorrelate(windowed)), bi, sample_rate, fmin, fmax)
    self_lag = rnd(self_lag)
    cand, freq = cand_l[:, 1 : bi - 1], freq_l[:, 1 : bi - 1]
    ix = torch.arange(1, bi - 1, device=dev)
    kvals, order = torch.topk(torch.where(cand, ix[None, :], bi), C, dim=-1, largest=False, sorted=True)
    valid = kvals < bi
    freq_c = torch.gather(freq, 1, order)
    offset = -bi - 1
    nx = bi - offset
    max_x = sample_rate / fmin - offset
    pos = torch.where(valid, sample_rate / freq_c - offset, float(bi) + 0.5)
    T = _max_effective_depth(offset, REFINE_SINC_DEPTH, max_x + 1.0)
    xb, fb = refine(self_lag, pos, valid, offset, REFINE_SINC_DEPTH, T)
    xmid = torch.where(pos == 0.0, torch.zeros_like(xb), torch.where(pos >= nx, torch.full_like(xb, float(nx)), xb))
    y_last = self_lag[:, nx - 1][:, None].expand_as(xb)
    ymid = torch.where(pos == 0.0, self_lag[:, :1].expand_as(xb), torch.where(pos >= nx, y_last, fb))
    strength_r = rnd(torch.where(ymid > 1.0, 1.0 / ymid, ymid))
    freq_r = rnd(sample_rate / (xmid + offset))

    freq_all = torch.cat([torch.where(valid, freq_r, 0.0), torch.zeros((B, 1), dtype=dt, device=dev)], dim=-1)
    strength_all = torch.cat([torch.where(valid, strength_r, -math.inf),
                              torch.full((B, 1), threshold, dtype=dt, device=dev)], dim=-1)
    valid_all = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=-1)
    order = torch.sort(-strength_all, dim=-1, stable=True).indices
    freq_s = torch.gather(freq_all, 1, order)
    valid_s = torch.gather(valid_all, 1, order)
    strength_s = torch.where(valid_s, torch.gather(strength_all, 1, order), 0.0)
    if max_candidates > C:
        pad = (0, max_candidates - C)
        freq_s, strength_s, valid_s = (torch.nn.functional.pad(t, pad) for t in (freq_s, strength_s, valid_s))
    return freq_s, strength_s, valid_s


# --- formants ---------------------------------------------------------------

def burg(x, p: int):
    """Burg LPC of (B, N) windowed frames: (coeffs (B, p) sign-flipped as
    in the reference, status with LPC_DENUM_NONPOS). num, denum and the
    reflection coefficient in float64 for every dtype."""
    n = x.shape[-1]
    batch = x.shape[:-1]
    z1 = torch.zeros(batch + (1,), dtype=x.dtype, device=x.device)
    b1 = torch.cat([x[..., : n - 1], z1], dim=-1)
    b2 = torch.cat([x[..., 1:], z1], dim=-1)
    coeffs = torch.zeros(batch + (p,), dtype=x.dtype, device=x.device)
    aa = torch.zeros_like(coeffs)
    status = torch.zeros(batch, dtype=torch.int32, device=x.device)
    for i in range(1, p + 1):
        m = n - i
        u, v = b1[..., :m].double(), b2[..., :m].double()
        num = torch.sum(u * v, dim=-1)
        denum = torch.sum(u**2 + v**2, dim=-1)
        bad = denum <= 0
        status = torch.where(bad, status | LPC_DENUM_NONPOS, status)
        ci = (2.0 * num / torch.where(bad, torch.ones_like(denum), denum)).to(x.dtype)
        head = aa[..., : i - 1] - ci[..., None] * aa[..., : i - 1].flip(-1)
        coeffs = torch.cat([head, ci[..., None], coeffs[..., i:]], dim=-1)
        if i < p:
            aa = torch.cat([coeffs[..., :i], aa[..., i:]], dim=-1)
            c = ci[..., None]
            b1, b2 = (b1 - c * b2,
                      torch.cat([b2[..., 1:], z1], dim=-1) - c * torch.cat([b1[..., 1:], z1], dim=-1))
    return -coeffs, status


class C(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor


def cadd(a, b):
    return C(a.re + b.re, a.im + b.im)


def csub(a, b):
    return C(a.re - b.re, a.im - b.im)


def cneg(a):
    return C(-a.re, -a.im)


def cmul(a, b):
    return C(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cdiv(a, b):
    nrm = b.re * b.re + b.im * b.im
    return C((a.re * b.re + a.im * b.im) / nrm, (a.im * b.re - a.re * b.im) / nrm)


def cnorm(a):
    return torch.hypot(a.re, a.im)


def csqrt(a):
    r, theta = cnorm(a), torch.atan2(a.im, a.re)
    r, theta = torch.sqrt(r), theta * 0.5
    return C(r * torch.cos(theta), r * torch.sin(theta))


def _horner_pdd(c: C, z: C):
    """p, p' and the p''/2 accumulator by one Horner pass (polynomial.rs:39-45)."""
    n = c.re.shape[-1]
    zero = torch.zeros_like(c.re[..., 0])
    g, b, a = C(zero, zero), C(zero, zero), C(c.re[..., n - 1], c.im[..., n - 1])
    for j in range(n - 2, -1, -1):
        g, b, a = cadd(cmul(g, z), b), cadd(cmul(b, z), a), cadd(cmul(a, z), C(c.re[..., j], c.im[..., j]))
    return a, b, g


def laguerre(c: C, n_lag, iters: int = 20) -> C:
    """Laguerre from -2 - 2i, `iters` steps, a lane frozen once |p(z)| <=
    1e-16; n_lag is the initial live degree, held through deflation."""
    batch = c.re.shape[:-1]
    dt, dev = c.re.dtype, c.re.device
    zero = torch.zeros(batch, dtype=dt, device=dev)
    n_c = C(n_lag, zero)
    nm1_c = C(n_lag - 1.0, zero)
    two = C(torch.full(batch, 2.0, dtype=dt, device=dev), zero)
    z = C(torch.full(batch, -2.0, dtype=dt, device=dev), torch.full(batch, -2.0, dtype=dt, device=dev))
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for _ in range(iters):
        p, dp, d2p = _horner_pdd(c, z)
        done = done | (cnorm(p) <= 1.0e-16)
        ca = cdiv(cneg(dp), p)
        ca2 = cmul(ca, ca)
        cb = csub(ca2, cdiv(cmul(two, d2p), p))
        c1 = csqrt(csub(cmul(cmul(nm1_c, n_c), cb), ca2))
        cc1, cc2 = cadd(ca, c1), csub(ca, c1)
        use1 = cnorm(cc1) > cnorm(cc2)
        z_new = cadd(z, cdiv(n_c, C(torch.where(use1, cc1.re, cc2.re), torch.where(use1, cc1.im, cc2.im))))
        z = C(torch.where(done, z.re, z_new.re), torch.where(done, z.im, z_new.im))
    return z


def _deflate(c: C, z: C, active) -> C:
    N = c.re.shape[-1]
    zeros = torch.zeros_like(c.re[..., 0])
    carry = C(zeros, zeros)
    q_re, q_im = [zeros], [zeros]
    for i in range(N - 2, -1, -1):
        carry = cadd(C(c.re[..., i + 1], c.im[..., i + 1]), cmul(z, carry))
        q_re.append(carry.re)
        q_im.append(carry.im)
    act = active[..., None]
    return C(torch.where(act, torch.stack(q_re[::-1], dim=-1), c.re),
             torch.where(act, torch.stack(q_im[::-1], dim=-1), c.im))


def find_roots(c: C):
    """All roots of (B, N) coefficient pairs, index = power
    (polynomial.rs:92-152): (roots, status)."""
    B, N = c.re.shape
    dt, dev = c.re.dtype, c.re.device
    idx = torch.arange(N, device=dev)
    nonzero = (c.re != 0) | (c.im != 0)
    deg = torch.amax(torch.where(nonzero, idx, 0), dim=-1)
    low = torch.amin(torch.where(nonzero, idx, N - 1), dim=-1)
    status = torch.where(deg < 1, POLY_ZERO_DEGREE, 0).to(torch.int32)
    m0 = deg - low
    src = idx + low[:, None]
    in_range = src < N
    src = src.clamp(max=N - 1)
    work = C(torch.where(in_range, torch.gather(c.re, 1, src), 0.0),
             torch.where(in_range, torch.gather(c.im, 1, src), 0.0))
    roots_re = torch.zeros_like(c.re)
    roots_im = torch.zeros_like(c.im)
    n_lag = m0.to(dt)
    for it in range(max(N - 3, 0)):
        active = (it < m0 - 2) & (status == 0)
        if not bool(active.any()):
            break
        z = laguerre(work, n_lag)
        status = torch.where(active & (z.re == 0) & (z.im == 0), status | POLY_DIV_ZERO, status)
        sel = active[:, None] & (idx == (low + it)[:, None])
        roots_re = torch.where(sel, z.re[:, None], roots_re)
        roots_im = torch.where(sel, z.im[:, None], roots_im)
        work = _deflate(work, z, active)
    zeros = torch.zeros(B, dtype=dt, device=dev)
    c0, c1, c2 = (C(work.re[:, k], work.im[:, k]) for k in range(3))
    zri = low + torch.clamp(m0 - 2, min=0)
    d = csqrt(csub(cmul(c1, c1), cmul(cmul(C(torch.full_like(zeros, 4.0), zeros), c2), c0)))
    a2 = cadd(c2, c2)
    rq1 = cdiv(cadd(cneg(c1), d), a2)
    rq2 = cdiv(csub(cneg(c1), d), a2)
    rl = cdiv(cneg(c0), c1)
    ok = (status & POLY_ZERO_DEGREE) == 0
    for sel, r in (((idx == zri[:, None]) & ((m0 >= 2) & ok)[:, None], rq1),
                   ((idx == (zri + 1)[:, None]) & ((m0 >= 2) & ok)[:, None], rq2),
                   ((idx == zri[:, None]) & ((m0 == 1) & ok)[:, None], rl)):
        roots_re = torch.where(sel, r.re[:, None], roots_re)
        roots_im = torch.where(sel, r.im[:, None], roots_im)
    return C(roots_re, roots_im), status


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    ca = a * 4097.0
    ah = ca - (ca - a)
    al = a - ah
    cb = b * 4097.0
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _df_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _quick_two_sum(s, e + x[1] + y[1])


def _df_add_f(x, f):
    s, e = _two_sum(x[0], f)
    return _quick_two_sum(s, e + x[1])


def _df_mul_f(x, f):
    p, e = _two_prod(x[0], f)
    return _quick_two_sum(p, e + x[1] * f)


def _horner_df(c: C, zr, zi):
    """p(z) in double-precision pairs, collapsed, and p'(z) in plain."""
    N = c.re.shape[-1]
    zero = torch.zeros_like(zr)
    ar, ai = (c.re[..., N - 1][..., None] + zero, zero), (c.im[..., N - 1][..., None] + zero, zero)
    br, bi = zero, zero
    for j in range(N - 2, -1, -1):
        br, bi = br * zr - bi * zi + ar[0], br * zi + bi * zr + ai[0]
        re = _df_add(_df_mul_f(ar, zr), _df_mul_f(ai, -zi))
        im = _df_add(_df_mul_f(ar, zi), _df_mul_f(ai, zr))
        ar = _df_add_f(re, c.re[..., j][..., None] + zero)
        ai = _df_add_f(im, c.im[..., j][..., None] + zero)
    return ar[0] + ar[1], ai[0] + ai[1], br, bi


def polish(c: C, z: C, iters: int = 2, max_step: float = 0.5) -> C:
    """Compensated Newton against the undeflated polynomial; a step is kept
    only while it lowers |p(z)|; zero slots stay."""
    live = (z.re != 0) | (z.im != 0)
    pr, pi, _, _ = _horner_df(c, z.re, z.im)
    best_r, best_i, best_n = z.re, z.im, pr * pr + pi * pi
    cur_r, cur_i = z.re, z.im
    for _ in range(iters):
        pr, pi, dpr, dpi = _horner_df(c, cur_r, cur_i)
        den = dpr * dpr + dpi * dpi
        dzr = (pr * dpr + pi * dpi) / den
        dzi = (pi * dpr - pr * dpi) / den
        ok = torch.isfinite(dzr) & torch.isfinite(dzi) & (dzr * dzr + dzi * dzi <= max_step * max_step)
        cur_r = torch.where(ok, cur_r - dzr, cur_r)
        cur_i = torch.where(ok, cur_i - dzi, cur_i)
        prn, pin_, _, _ = _horner_df(c, cur_r, cur_i)
        n_new = prn * prn + pin_ * pin_
        better = n_new < best_n
        best_r = torch.where(better, cur_r, best_r)
        best_i = torch.where(better, cur_i, best_i)
        best_n = torch.where(better, n_new, best_n)
    return C(torch.where(live, best_r, z.re), torch.where(live, best_i, z.im))


def resonances(roots: C, sample_rate: float, capacity: int = MAX_RESONANCES):
    """Roots -> (freq, bw), valid ones first by frequency, zero-padded to
    `capacity` (spectrum.rs:166-192, lib.rs:94-111)."""
    freq_mul = sample_rate / (2.0 * math.pi)
    r, theta = cnorm(roots), torch.atan2(roots.im, roots.re)
    nrm = roots.re * roots.re + roots.im * roots.im
    inv = C(roots.re / nrm, roots.im / nrm)  # 1 / conj(z)
    outside = r > 1.0
    r = torch.where(outside, cnorm(inv), r)
    theta = torch.where(outside, torch.atan2(inv.im, inv.re), theta)
    freq = freq_mul * theta
    bw = -2.0 * freq_mul * torch.log(r)
    valid = (roots.im > 0) & (freq > 50.0) & (freq < sample_rate * 0.5 - 50.0)
    valid = valid & torch.isfinite(freq) & torch.isfinite(bw)
    order = torch.sort(torch.where(valid, freq, math.inf), dim=-1, stable=True).indices
    valid_s = torch.gather(valid, -1, order)
    freq_s = torch.where(valid_s, torch.gather(freq, -1, order), 0.0)
    bw_s = torch.where(valid_s, torch.gather(bw, -1, order), 0.0)
    pad = (0, max(0, capacity - freq.shape[-1]))
    return (torch.nn.functional.pad(freq_s, pad)[..., :capacity],
            torch.nn.functional.pad(bw_s, pad)[..., :capacity])


def formant_candidates(frames, sample_rate: float, n_coeffs: int, polish_f32: bool = True, rnd=_same):
    """Per-frame resonance buffers (freq, bw (B, 32)) and Burg/roots status
    of (B, n) raw frames."""
    B, n = frames.shape
    buf = frames * _table(hann, n, frames)
    coeffs, status = burg(buf, n_coeffs)
    coeffs = rnd(coeffs)
    poly_re = torch.cat([coeffs.flip(-1), torch.ones((B, 1), dtype=frames.dtype, device=frames.device)], dim=-1)
    poly = C(poly_re, torch.zeros_like(poly_re))
    roots, rstatus = find_roots(poly)
    roots = C(rnd(roots.re), rnd(roots.im))
    if polish_f32 and frames.dtype == torch.float32:
        roots = polish(poly, roots)
    rfreq, rbw = resonances(roots, sample_rate)
    return rfreq, rbw, status | rstatus


def track_step(est_f, est_b, res_f, res_b):
    """One McCandless update (spectrum.rs:232-333), batched over leading
    axes: est_* (..., L) the previous estimates, res_* (..., R) the frame's
    resonance buffer, zero tail included. Returns the new (est_f, est_b)."""
    L = est_f.shape[-1]
    batch = est_f.shape[:-1]
    dev = est_f.device
    ns = min(L, NSLOTS)
    slot = torch.arange(NSLOTS, device=dev)

    def put(arr, j, value, mask):
        return torch.where((slot == j) & mask[..., None], value[..., None], arr)

    nearest = torch.argmin(torch.abs(res_f[..., None, :] - est_f[..., :ns, None]), dim=-1)
    sf = torch.nn.functional.pad(torch.gather(res_f, -1, nearest), (0, NSLOTS - ns))
    sb = torch.nn.functional.pad(torch.gather(res_b, -1, nearest), (0, NSLOTS - ns))
    sv = torch.broadcast_to(slot < ns, batch + (NSLOTS,))
    w = torch.zeros(batch, dtype=torch.int64, device=dev)
    unassigned = torch.zeros(batch, dtype=torch.bool, device=dev)
    for r in range(1, NSLOTS):
        vf, vb, vv = sf[..., r], sb[..., r], sv[..., r]
        same = vv & (vf == torch.gather(sf, -1, w[..., None])[..., 0]) & (vb == torch.gather(sb, -1, w[..., None])[..., 0])
        est_w = torch.gather(est_f, -1, torch.clamp(w, max=L - 1)[..., None])[..., 0]
        closer = torch.abs(vf - est_f[..., min(r, L - 1)]) < torch.abs(vf - est_w)
        sv = torch.where((slot == w[..., None]) & (same & closer)[..., None], False, sv)
        sv = put(sv, r, torch.zeros_like(same), same & ~closer)
        unassigned = unassigned | same
        w = torch.where((same & closer) | (~same & vv), r, w)
    true_ = torch.ones(batch, dtype=torch.bool, device=dev)
    for j in range(min(res_f.shape[-1], NSLOTS)):
        pf, pb = res_f[..., j], res_b[..., j]
        can = unassigned & ~torch.any(sv & (sf == pf[..., None]) & (sb == pb[..., None]), dim=-1)
        b1 = can & ~sv[..., j]
        sf, sb, sv = put(sf, j, pf, b1), put(sb, j, pb, b1), put(sv, j, true_, b1)
        can = can & ~b1
        for k, ok in ((j - 1, j > 0), (j + 1, j + 1 < NSLOTS)):
            if not ok:
                continue
            bk = can & ~sv[..., k]
            of, ob, ov = sf[..., j], sb[..., j], sv[..., j]
            sf = put(put(sf, k, of, bk), j, pf, bk)
            sb = put(put(sb, k, ob, bk), j, pb, bk)
            sv = put(put(sv, k, ov, bk), j, true_, bk)
            can = can & ~bk
    order = torch.sort(torch.where(sv, sf, -math.inf), dim=-1, stable=True).indices
    sf, sb, sv = (torch.gather(t, -1, order) for t in (sf, sb, sv))
    winner = sv & (sf > 0)
    worder = torch.sort((~winner).to(torch.uint8), dim=-1, stable=True).indices
    wf = torch.gather(sf, -1, worder)
    wb = torch.gather(sb, -1, worder)
    if L > NSLOTS:
        wf, wb = (torch.nn.functional.pad(t, (0, L - NSLOTS)) for t in (wf, wb))
    take = torch.arange(L, device=dev) < torch.sum(winner, dim=-1)[..., None]
    return torch.where(take, wf[..., :L], est_f), torch.where(take, wb[..., :L], est_b)


# --- MFCC -------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _banks(n: int, num_coeffs: int, lo: float, hi: float, sample_rate: float):
    """The exact-mode filterbank folded onto the rfft half spectrum: (power
    weights, magnitude weights), each (n//2 + 1, num_coeffs)."""
    def to_mel(hz):
        return 1125.0 * math.log1p(hz / 700.0)

    mel_lo, mel_hi = to_mel(lo), to_mel(hi)
    points = [(i / num_coeffs) * (mel_hi - mel_lo) + mel_lo for i in range(num_coeffs + 2)]
    bins = [int(math.floor((n + 1) * 700.0 * (math.exp(p / 1125.0) - 1.0) / sample_rate)) for p in points]
    w_pow = np.zeros((num_coeffs, n))
    w_mag = np.zeros((num_coeffs, n))
    for f in range(num_coeffs):
        b0, b1, b2 = bins[f], bins[f + 1], bins[f + 2]
        for i, b in enumerate(range(b0, b1)):
            if b < n:
                w_pow[f, b] += i / (b1 - b0)
        for i, b in enumerate(range(b1, b2)):
            if b < n:
                w_mag[f, b] += i / (b2 - b1)
    fold = np.zeros((n, n // 2 + 1))
    for k in range(n):
        fold[k, k if k <= n // 2 else n - k] = 1.0
    return (w_pow @ fold).T, (w_mag @ fold).T


@functools.lru_cache(maxsize=8)
def _dct(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))


def mfcc(windowed, num_coeffs: int, lo: float, hi: float, sample_rate: float, rnd=_same):
    """Exact-mode MFCC of (B, n) windowed frames -> (B, num_coeffs)."""
    n = windowed.shape[-1]
    wp, wm = (torch.as_tensor(w, dtype=windowed.dtype, device=windowed.device)
              for w in _banks(n, num_coeffs, lo, hi, sample_rate))
    spec = torch.fft.rfft(windowed, dim=-1)
    half_pow = rnd((spec.real.square() + spec.imag.square()).to(windowed.dtype))
    energies = torch.matmul(half_pow, rnd(wp)) + torch.matmul(rnd(torch.sqrt(half_pow)), rnd(wm))
    log_e = rnd(torch.clamp(torch.log10(torch.clamp(energies, min=0.0)), min=1e-10))
    dct = torch.as_tensor(_dct(num_coeffs), dtype=windowed.dtype, device=windowed.device)
    return torch.matmul(log_e, rnd(dct).T)
