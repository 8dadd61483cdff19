"""Kernel C: all roots of each frame's complex polynomial (csrc/roots.cu;
replaces voxtpu/ops/roots_pallas.py's `find_roots_pallas`).

`find_roots_plain` is the PyTorch version of `voxtpu.roots.find_roots`
(polynomial.rs:92-152): leading zeros shift out as zero roots, then
max(N-3, 0) rounds of 20-iteration Laguerre plus synthetic deflation, then
the closed-form quadratic or linear tail. `find_roots` runs it for CPU
tensors and launches the kernel, one thread per polynomial, for CUDA
tensors.
"""

from __future__ import annotations

import torch

from voxtpu_torch import errors
from voxtpu_torch.cplx import C, cadd, cdiv, cmul, cneg, csqrt, csub
from voxtpu_torch.ops import kernels

__all__ = ["find_roots_plain", "find_roots"]

_MAX_N = 32  # csrc/roots.cu kMaxN


def find_roots_plain(c_re: torch.Tensor, c_im: torch.Tensor):
    """Roots of (B, N) coefficient pairs (index = power).

    Returns (roots_re, roots_im (B, N), count (B,) int32 = degree,
    status (B,) int32 with POLY_ZERO_DEGREE / POLY_DIV_ZERO)."""
    from voxtpu_torch.roots import _deflate, degree, laguerre, off_low

    c = C(c_re, c_im)
    B, N = c_re.shape
    dt, dev = c_re.dtype, c_re.device
    deg = degree(c)
    low = off_low(c)
    status = torch.where(deg < 1, errors.POLY_ZERO_DEGREE, 0).to(torch.int32)
    m0 = deg - low  # live degree to factor

    # Shift the x^low factor out (polynomial.rs:103-106, intended semantics).
    idx = torch.arange(N, device=dev)
    src = idx + low[:, None]
    in_range = src < N
    src = src.clamp(max=N - 1)
    work = C(
        torch.where(in_range, torch.gather(c_re, 1, src), 0.0),
        torch.where(in_range, torch.gather(c_im, 1, src), 0.0),
    )
    roots_re = torch.zeros_like(c_re)
    roots_im = torch.zeros_like(c_im)

    start = C(torch.tensor(-2.0, dtype=dt, device=dev), torch.tensor(-2.0, dtype=dt, device=dev))
    # Laguerre's n is the initial live degree, held through deflation.
    n_lag = m0.to(dt)
    for it in range(max(N - 3, 0)):
        active = (it < m0 - 2) & (status == 0)
        z = laguerre(work, start, n_lag=n_lag)
        div_zero = active & (z.re == 0) & (z.im == 0)
        status = torch.where(div_zero, status | errors.POLY_DIV_ZERO, status)
        sel = active[:, None] & (idx == (low + it)[:, None])
        roots_re = torch.where(sel, z.re[:, None], roots_re)
        roots_im = torch.where(sel, z.im[:, None], roots_im)
        work = _deflate(work, z, active)

    # Tails: the live quadratic/linear sits at indices 0..2.
    zeros = torch.zeros(B, dtype=dt, device=dev)
    c0 = C(work.re[:, 0], work.im[:, 0])
    c1 = C(work.re[:, 1], work.im[:, 1]) if N >= 2 else C(zeros, zeros)
    c2 = C(work.re[:, 2], work.im[:, 2]) if N >= 3 else C(zeros, zeros)
    zri = low + torch.clamp(m0 - 2, min=0)

    # Quadratic: (x +/- d) / (2 c2), d = sqrt(c1^2 - 4 c2 c0), x = -c1.
    a2 = cadd(c2, c2)
    four = C(torch.full_like(zeros, 4.0), zeros)
    d = csqrt(csub(cmul(c1, c1), cmul(cmul(four, c2), c0)))
    xq = cneg(c1)
    rq1 = cdiv(cadd(xq, d), a2)
    rq2 = cdiv(csub(xq, d), a2)
    rl = cdiv(cneg(c0), c1)  # linear: -c0 / c1

    ok = (status & errors.POLY_ZERO_DEGREE) == 0
    is_quad = (m0 >= 2) & ok
    is_lin = (m0 == 1) & ok
    sel1 = (idx == zri[:, None]) & is_quad[:, None]
    sel2 = (idx == (zri + 1)[:, None]) & is_quad[:, None]
    sel_l = (idx == zri[:, None]) & is_lin[:, None]
    roots_re = torch.where(sel1, rq1.re[:, None], roots_re)
    roots_im = torch.where(sel1, rq1.im[:, None], roots_im)
    roots_re = torch.where(sel2, rq2.re[:, None], roots_re)
    roots_im = torch.where(sel2, rq2.im[:, None], roots_im)
    roots_re = torch.where(sel_l, rl.re[:, None], roots_re)
    roots_im = torch.where(sel_l, rl.im[:, None], roots_im)
    return roots_re, roots_im, deg.to(torch.int32), status


def find_roots(c_re: torch.Tensor, c_im: torch.Tensor):
    """`find_roots_plain` for CPU tensors; on the card, csrc/roots.cu."""
    if kernels.on_cpu(c_re, c_im):
        return find_roots_plain(c_re, c_im)
    if c_re.dim() != 2 or c_re.shape != c_im.shape or not 1 <= c_re.shape[1] <= _MAX_N:
        raise ValueError(f"find_roots: c_re, c_im (B, N <= {_MAX_N}); got {c_re.shape}, {c_im.shape}")
    if c_im.dtype != c_re.dtype:
        raise TypeError("find_roots: c_re and c_im must share a dtype")
    B, N = c_re.shape
    c_re, c_im = c_re.contiguous(), c_im.contiguous()
    r_re = torch.empty_like(c_re)
    r_im = torch.empty_like(c_re)
    count = torch.empty((B,), dtype=torch.int32, device=c_re.device)
    status = torch.empty((B,), dtype=torch.int32, device=c_re.device)
    kernels.launch("vt_roots", c_re.dtype, c_re, c_im, r_re, r_im, count, status, B, N)
    find_roots.launches += 1
    return r_re, r_im, count, status


find_roots.launches = 0
