"""Batched polynomial root finding: Laguerre iteration + synthetic deflation.

Port of voxtpu.roots (reference: polynomial.rs). `find_roots` runs through
kernel C (voxtpu_torch.ops.find_roots): the CUDA kernel for coefficients on
the card, the plain PyTorch version, built from `laguerre` and `_deflate`
below, for coefficients on the CPU. Quirks kept: Laguerre's `n` is the
initial live degree held through deflation, the Horner accumulator order,
the |p(z)| <= 1e-16 freeze, the larger-hypot denominator choice, and the
principal (polar) complex sqrt in the quadratic tail.

`polish_roots` (the f32 compensated-Newton polish of voxtpu.roots) is plain
PyTorch, as in voxtpu.
"""

from __future__ import annotations

import torch

from voxtpu_torch.cplx import C, cadd, cdiv, cmul, cneg, cnorm, csqrt, csub
from voxtpu_torch.ops import find_roots as _find_roots

__all__ = ["degree", "off_low", "laguerre", "find_roots", "polish_roots"]


def degree(c: C) -> torch.Tensor:
    """Index of the highest nonzero coefficient (0 if none). polynomial.rs:26-28."""
    nonzero = (c.re != 0) | (c.im != 0)
    idx = torch.arange(nonzero.shape[-1], device=nonzero.device)
    return torch.amax(torch.where(nonzero, idx, 0), dim=-1)


def off_low(c: C) -> torch.Tensor:
    """Index of the lowest nonzero coefficient (N-1 if none). polynomial.rs:30-32."""
    nonzero = (c.re != 0) | (c.im != 0)
    n = nonzero.shape[-1]
    idx = torch.arange(n, device=nonzero.device)
    return torch.amin(torch.where(nonzero, idx, n - 1), dim=-1)


def _horner_pdd(c: C, z: C) -> tuple[C, C, C]:
    """p, p' and the p''/2 accumulator by one Horner pass (polynomial.rs:39-45)."""
    n = c.re.shape[-1]
    zero = torch.zeros_like(c.re[..., 0])
    a = C(c.re[..., n - 1], c.im[..., n - 1])
    b = C(zero, zero)
    g = C(zero, zero)
    for j in range(n - 2, -1, -1):
        g = cadd(cmul(g, z), b)
        b = cadd(cmul(b, z), a)
        a = cadd(cmul(a, z), C(c.re[..., j], c.im[..., j]))
    return a, b, g


def laguerre(c: C, start: C, n_lag: torch.Tensor | int | None = None, iters: int = 20) -> C:
    """Batched Laguerre iteration (polynomial.rs:34-72) on (..., N) pairs,
    `iters` fixed steps from `start`, each lane frozen once |p(z)| <= 1e-16.
    n_lag: the `n` of the update (default N-1; per-lane during deflation)."""
    N = c.re.shape[-1]
    batch = c.re.shape[:-1]
    dt, dev = c.re.dtype, c.re.device
    if n_lag is None:
        n_lag = N - 1
    nf = torch.broadcast_to(torch.as_tensor(n_lag, dtype=dt, device=dev), batch)
    n_c = C(nf, torch.zeros_like(nf))
    nm1_c = C(nf - 1.0, torch.zeros_like(nf))
    two = C(torch.full(batch, 2.0, dtype=dt, device=dev), torch.zeros(batch, dtype=dt, device=dev))
    z = C(
        torch.broadcast_to(torch.as_tensor(start.re, dtype=dt, device=dev), batch),
        torch.broadcast_to(torch.as_tensor(start.im, dtype=dt, device=dev), batch),
    )
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for _ in range(iters):
        p, dp, d2p = _horner_pdd(c, z)
        done = done | (cnorm(p) <= 1.0e-16)
        ca = cdiv(cneg(dp), p)
        ca2 = cmul(ca, ca)
        cb = csub(ca2, cdiv(cmul(two, d2p), p))
        c1 = csqrt(csub(cmul(cmul(nm1_c, n_c), cb), ca2))
        cc1 = cadd(ca, c1)
        cc2 = csub(ca, c1)
        use1 = cnorm(cc1) > cnorm(cc2)
        denom = C(torch.where(use1, cc1.re, cc2.re), torch.where(use1, cc1.im, cc2.im))
        z_new = cadd(z, cdiv(n_c, denom))
        z = C(torch.where(done, z.re, z_new.re), torch.where(done, z.im, z_new.im))
    return z


def _deflate(c: C, z: C, active: torch.Tensor) -> C:
    """Synthetic division of (..., N) pairs by (x - z) where `active`
    (div_polynomial_mut, polynomial.rs:155-195): q[i] = p[i+1] + z q[i+1],
    top coefficient zeroed."""
    N = c.re.shape[-1]
    zeros = torch.zeros_like(c.re[..., 0])
    carry = C(zeros, zeros)
    q_re, q_im = [zeros], [zeros]
    for i in range(N - 2, -1, -1):
        carry = cadd(C(c.re[..., i + 1], c.im[..., i + 1]), cmul(z, carry))
        q_re.append(carry.re)
        q_im.append(carry.im)
    new_re = torch.stack(q_re[::-1], dim=-1)
    new_im = torch.stack(q_im[::-1], dim=-1)
    act = active[..., None]
    return C(torch.where(act, new_re, c.re), torch.where(act, new_im, c.im))


def find_roots(c: C) -> tuple[C, torch.Tensor, torch.Tensor]:
    """All roots of (..., N) coefficient pairs, index = power
    (polynomial.rs:92-152).

    Returns (roots (..., N) pairs with zeros past the count; count (...,)
    int32 = degree; status (...,) int32 with POLY_ZERO_DEGREE /
    POLY_DIV_ZERO)."""
    batch = c.re.shape[:-1]
    N = c.re.shape[-1]
    rre, rim, count, status = _find_roots.find_roots(c.re.reshape(-1, N), c.im.reshape(-1, N))
    return C(rre.reshape(batch + (N,)), rim.reshape(batch + (N,))), count.reshape(batch), status.reshape(batch)


# ---- compensated (double-float32) Newton polish ----------------------------
# Error-free transforms (Knuth two_sum, Dekker split/two_prod) evaluate the
# ORIGINAL polynomial's residual to ~f64 accuracy in f32, so a couple of
# Newton steps recover the accuracy that deflation lost (voxtpu.roots).


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


_SPLIT = 4097.0  # 2**12 + 1: Dekker split point for the 24-bit f32 significand


def _two_prod(a, b):
    p = a * b
    ca = a * _SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * _SPLIT
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
    """p(z) in double-f32 (collapsed at the end) and p'(z) in plain f32;
    c (..., N), z (..., M): every root slot evaluates its frame's polynomial."""
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
        re = _df_add(_df_mul_f(ar, zr), _df_mul_f(ai, -zi))
        im = _df_add(_df_mul_f(ar, zi), _df_mul_f(ai, zr))
        cr, ci = coef(j)
        ar = _df_add_f(re, cr)
        ai = _df_add_f(im, ci)
    return ar[0] + ar[1], ai[0] + ai[1], br, bi


def polish_roots(c: C, roots: C, iters: int = 2, max_step: float = 0.5) -> C:
    """Compensated-Newton refinement of f32 roots against the original
    polynomial. A step is kept only while it reduces |p(z)|; zero root slots
    stay untouched."""
    zr0, zi0 = roots.re, roots.im
    live = (zr0 != 0) | (zi0 != 0)
    pr, pi, _, _ = _horner_df(c, zr0, zi0)
    best_r, best_i = zr0, zi0
    best_n = pr * pr + pi * pi
    cur_r, cur_i = zr0, zi0
    ms2 = max_step * max_step
    for _ in range(iters):
        pr, pi, dpr, dpi = _horner_df(c, cur_r, cur_i)
        den = dpr * dpr + dpi * dpi
        dzr = (pr * dpr + pi * dpi) / den
        dzi = (pi * dpr - pr * dpi) / den
        ok = torch.isfinite(dzr) & torch.isfinite(dzi) & (dzr * dzr + dzi * dzi <= ms2)
        cur_r = torch.where(ok, cur_r - dzr, cur_r)
        cur_i = torch.where(ok, cur_i - dzi, cur_i)
        prn, pin_, _, _ = _horner_df(c, cur_r, cur_i)
        n_new = prn * prn + pin_ * pin_
        better = n_new < best_n  # False for NaN
        best_r = torch.where(better, cur_r, best_r)
        best_i = torch.where(better, cur_i, best_i)
        best_n = torch.where(better, n_new, best_n)
    return C(torch.where(live, best_r, zr0), torch.where(live, best_i, zi0))
