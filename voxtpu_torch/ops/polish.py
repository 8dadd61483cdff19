"""Kernel P: the float32 compensated-Newton root polish (csrc/polish.cu;
the counterpart of voxtpu/roots.py's `polish_roots`, which is jnp that XLA
fuses into one program: there is no Pallas kernel).

`polish_roots_plain` is the PyTorch version: error-free transforms (Knuth
two_sum, Dekker split/two_prod) evaluate the ORIGINAL polynomial's residual
in double-f32, so a couple of Newton steps recover the accuracy that
deflation lost. Eager PyTorch runs it as about 9,300 elementwise launches a
call. `polish_roots` runs it for CPU tensors, at any N, and launches the
kernel, one thread a root slot, for CUDA tensors, at N <= _MAX_N = 128 (LPC
orders up to 127, as the roots kernel). The outputs are bit-identical: the
kernel repeats every operation whose result is used, in the same order and
precision, and evaluates each point once where this version evaluates it
twice (see the note in csrc/polish.cu). N = _N runs with the coefficients
in registers.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import kernels

__all__ = ["polish_roots_plain", "polish_roots"]

# Mirrors of csrc/polish.cu's constants.
_N = 14  # kN
_MAX_N = 128  # kMaxN


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


# 2**12 + 1: Dekker split point for the 24-bit f32 significand; float64
# uses it too, as voxtpu does (mirrored as kSplit in csrc/polish.cu).
_SPLIT = 4097.0


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


def _horner_df(c_re, c_im, zr, zi):
    """p(z) in double-f32 (collapsed at the end) and p'(z) in plain f32;
    c (..., N), z (..., M): every root slot evaluates its frame's polynomial."""
    N = c_re.shape[-1]
    zero = torch.zeros_like(zr)

    def coef(j):
        return c_re[..., j][..., None] + zero, c_im[..., j][..., None] + zero

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


def polish_roots_plain(
    c_re: torch.Tensor, c_im: torch.Tensor, z_re: torch.Tensor, z_im: torch.Tensor,
    iters: int = 2, max_step: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compensated-Newton refinement of the roots (z_re, z_im) against the
    original polynomial (c_re, c_im), index = power. A step is kept only
    while it reduces |p(z)|; zero root slots stay untouched. Returns the
    polished (re, im)."""
    zr0, zi0 = z_re, z_im
    live = (zr0 != 0) | (zi0 != 0)
    pr, pi, _, _ = _horner_df(c_re, c_im, zr0, zi0)
    best_r, best_i = zr0, zi0
    best_n = pr * pr + pi * pi
    cur_r, cur_i = zr0, zi0
    ms2 = max_step * max_step
    for _ in range(iters):
        pr, pi, dpr, dpi = _horner_df(c_re, c_im, cur_r, cur_i)
        den = dpr * dpr + dpi * dpi
        dzr = (pr * dpr + pi * dpi) / den
        dzi = (pi * dpr - pr * dpi) / den
        ok = torch.isfinite(dzr) & torch.isfinite(dzi) & (dzr * dzr + dzi * dzi <= ms2)
        cur_r = torch.where(ok, cur_r - dzr, cur_r)
        cur_i = torch.where(ok, cur_i - dzi, cur_i)
        prn, pin_, _, _ = _horner_df(c_re, c_im, cur_r, cur_i)
        n_new = prn * prn + pin_ * pin_
        better = n_new < best_n  # False for NaN
        best_r = torch.where(better, cur_r, best_r)
        best_i = torch.where(better, cur_i, best_i)
        best_n = torch.where(better, n_new, best_n)
    return torch.where(live, best_r, zr0), torch.where(live, best_i, zi0)


def polish_roots(
    c_re: torch.Tensor, c_im: torch.Tensor, z_re: torch.Tensor, z_im: torch.Tensor,
    iters: int = 2, max_step: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`polish_roots_plain` over (F, N) coefficients and (F, N) roots of
    one dtype: for CPU tensors the plain version, on the card one launch of
    csrc/polish.cu."""
    ts = (c_re, c_im, z_re, z_im)
    cpu = kernels.on_cpu(*ts)
    if c_re.dim() != 2 or any(t.shape != c_re.shape for t in ts):
        raise ValueError(f"polish_roots: coefficients and roots are all (F, N), got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != c_re.dtype for t in ts):
        raise TypeError(f"polish_roots: coefficients and roots share a dtype, got {[t.dtype for t in ts]}")
    if iters < 0:
        raise ValueError(f"polish_roots: iters >= 0, got {iters}")
    if cpu:
        return polish_roots_plain(c_re, c_im, z_re, z_im, iters, max_step)
    F, N = c_re.shape
    if N > _MAX_N:
        raise ValueError(f"polish_roots: the card takes N <= {_MAX_N} (LPC orders up to {_MAX_N - 1}); got N = {N}")
    c_re, c_im, z_re, z_im = (t.contiguous() for t in ts)
    out_re, out_im = torch.empty_like(z_re), torch.empty_like(z_im)
    kernels.launch("vt_polish", c_re.dtype, c_re, c_im, z_re, z_im, out_re, out_im, F, N, iters,
                   float(max_step) * float(max_step))
    polish_roots.launches += 1
    return out_re, out_im


polish_roots.launches = 0
