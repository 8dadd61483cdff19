"""Complex arithmetic as (re, im) real-tensor pairs.

Port of voxtpu.cplx. PyTorch has complex dtypes, but the pairs are kept so
the root finder diffs line for line with voxtpu and with the CUDA kernel
(csrc/roots.cu), which uses the same formulas:

- division uses the naive (re*re+im*im) formula (num-complex `Div`),
- `norm` is hypot, `arg` is atan2,
- `sqrt` is the principal branch via polar form (complex.rs:13-18),
- `inv` is conj/norm_sqr.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "C", "cmul", "cdiv", "cadd", "csub", "cneg", "cconj", "cinv", "cnorm",
    "cnorm_sqr", "carg", "csqrt", "to_polar", "from_polar",
]


class C(NamedTuple):
    """A complex value as a pair of real tensors."""

    re: torch.Tensor
    im: torch.Tensor


def cadd(a: C, b: C) -> C:
    return C(a.re + b.re, a.im + b.im)


def csub(a: C, b: C) -> C:
    return C(a.re - b.re, a.im - b.im)


def cneg(a: C) -> C:
    return C(-a.re, -a.im)


def cconj(a: C) -> C:
    return C(a.re, -a.im)


def cmul(a: C, b: C) -> C:
    return C(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cdiv(a: C, b: C) -> C:
    # num-complex naive division: (a * conj(b)) / |b|^2
    nrm = b.re * b.re + b.im * b.im
    return C((a.re * b.re + a.im * b.im) / nrm, (a.im * b.re - a.re * b.im) / nrm)


def cnorm_sqr(a: C) -> torch.Tensor:
    return a.re * a.re + a.im * a.im


def cnorm(a: C) -> torch.Tensor:
    return torch.hypot(a.re, a.im)


def carg(a: C) -> torch.Tensor:
    return torch.atan2(a.im, a.re)


def to_polar(a: C) -> tuple[torch.Tensor, torch.Tensor]:
    return cnorm(a), carg(a)


def from_polar(r: torch.Tensor, theta: torch.Tensor) -> C:
    return C(r * torch.cos(theta), r * torch.sin(theta))


def cinv(a: C) -> C:
    nrm = cnorm_sqr(a)
    return C(a.re / nrm, -a.im / nrm)


def csqrt(a: C) -> C:
    """Principal complex square root via polar form (complex.rs:13-18)."""
    r, theta = to_polar(a)
    return from_polar(torch.sqrt(r), theta * 0.5)
