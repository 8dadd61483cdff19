"""Batched polynomial root finding: Laguerre iteration + synthetic deflation.

Port of voxtpu.roots (reference: polynomial.rs). `find_roots` runs through
kernel C (voxtpu_torch.ops.find_roots): the CUDA kernel for coefficients on
the card, the plain PyTorch version, built from `laguerre` and `_deflate`
below, for coefficients on the CPU. Quirks kept: Laguerre's `n` is the
initial live degree held through deflation, the Horner accumulator order,
the |p(z)| <= 1e-16 freeze, the larger-hypot denominator choice, and the
principal (polar) complex sqrt in the quadratic tail.

`polish_roots` (the f32 compensated-Newton polish of voxtpu.roots) runs
through kernel P (voxtpu_torch.ops.polish) the same way: the CUDA kernel on
the card, its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import torch

from voxtpu_torch.cplx import C, cadd, cdiv, cmul, cneg, cnorm, csqrt, csub
from voxtpu_torch.ops import find_roots as _find_roots
from voxtpu_torch.ops import polish as _polish

__all__ = ["degree", "off_low", "laguerre", "find_roots", "polish_roots", "div_polynomial"]


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
    """p, p' and the p''/2 accumulator by one Horner pass (polynomial.rs:39-45):
    g = g z + b, b = b z + a, a = a z + c[j], each from the values before
    the step, stacked as (g, b, a) so that one complex multiply-add serves
    all three (the same operations on each, a third of the launches)."""
    n = c.re.shape[-1]
    zero = torch.zeros_like(c.re[..., 0])
    x_re = torch.stack([zero, zero, c.re[..., n - 1]])
    x_im = torch.stack([zero, zero, c.im[..., n - 1]])
    for j in range(n - 2, -1, -1):
        y_re = torch.cat([x_re[1:], c.re[..., j][None]])
        y_im = torch.cat([x_im[1:], c.im[..., j][None]])
        x_re, x_im = x_re * z.re - x_im * z.im + y_re, x_re * z.im + x_im * z.re + y_im
    return C(x_re[2], x_im[2]), C(x_re[1], x_im[1]), C(x_re[0], x_im[0])


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


def polish_roots(c: C, roots: C, iters: int = 2, max_step: float = 0.5) -> C:
    """Compensated-Newton refinement of f32 roots against the original
    polynomial (kernel P, voxtpu_torch.ops.polish). A step is kept only
    while it reduces |p(z)|; zero root slots stay untouched. c and roots:
    (..., N) pairs of one shape."""
    batch = c.re.shape[:-1]
    N = c.re.shape[-1]
    if roots.re.shape != c.re.shape:
        raise ValueError(f"polish_roots: roots {tuple(roots.re.shape)} must match coefficients {tuple(c.re.shape)}")
    re, im = _polish.polish_roots(*(t.reshape(-1, N) for t in (c.re, c.im, roots.re, roots.im)),
                                  iters=iters, max_step=max_step)
    return C(re.reshape(batch + (N,)), im.reshape(batch + (N,)))


def div_polynomial(c: C, z: C) -> tuple[C, C]:
    """Synthetic division of (..., N) pairs by the monic linear factor
    (x + z): the reference's `div_polynomial(self, other)`
    (polynomial.rs:155-204, `other` the divisor's constant).

    Returns (quotient, remainder): the quotient with its top coefficient
    zeroed, as the in-place version leaves it (polynomial.rs:174-181), and
    the remainder p(-z) at index 0 of an otherwise zero (..., N) polynomial.
    """
    batch = c.re.shape[:-1]
    # _deflate divides by (x - root): dividing by (x + z) means root = -z.
    root = cneg(C(torch.as_tensor(z.re, dtype=c.re.dtype, device=c.re.device).expand(batch),
                  torch.as_tensor(z.im, dtype=c.im.dtype, device=c.im.device).expand(batch)))
    q = _deflate(c, root, torch.ones(batch, dtype=torch.bool, device=c.re.device))
    N = c.re.shape[-1]
    rem = C(c.re[..., N - 1], c.im[..., N - 1])
    for j in range(N - 2, -1, -1):
        rem = cadd(cmul(rem, root), C(c.re[..., j], c.im[..., j]))
    at0 = torch.arange(N, device=c.re.device) == 0
    return q, C(torch.where(at0, rem.re[..., None], 0.0), torch.where(at0, rem.im[..., None], 0.0))
