"""Batched autocorrelation through torch.fft, with the reference's seed quirk.

Port of voxtpu.autocorr's "fft" branch. The reference (periodic.rs:276-289)
seeds its accumulator with x[0] and skips the i=0 term, so

    r[lag] = AC_true[lag] - x[0]*x[lag] + x[0]

which is applied here as a closed-form correction after one batched
rfft -> |.|^2 -> irfft. On a GPU the transform is cuFFT. The fused
power+autocorrelation kernel (voxtpu's "ct_fused" backend, which power-of-two
frames take on a TPU) is not ported yet: any backend other than "fft" raises.
"""

from __future__ import annotations

import torch

__all__ = ["autocorrelate", "power_and_autocorrelate"]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _check_backend(backend: str | None) -> None:
    if backend not in (None, "fft"):
        raise NotImplementedError(
            f"autocorrelation backend {backend!r} is not yet ported; only 'fft' is"
        )


def _power(x: torch.Tensor, nfft: int) -> torch.Tensor:
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    return (spec.real.square() + spec.imag.square()).to(x.dtype)


def _quirk(ac: torch.Tensor, x: torch.Tensor, n_coeffs: int) -> torch.Tensor:
    x0 = x[..., :1]
    return ac - x0 * x[..., :n_coeffs] + x0


def power_and_autocorrelate(
    x: torch.Tensor, n_coeffs: int | None = None, quirk: bool = True,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation plus the n-point half power spectrum.

    Returns (half_power (..., n//2+1), ac (..., n_coeffs)). For power-of-two
    frames nfft == 2n and the half spectrum is the even bins of the 2n-point
    one; otherwise a second n-point transform gives it (voxtpu's cold path).
    """
    _check_backend(backend)
    n = x.shape[-1]
    if n_coeffs is None:
        n_coeffs = n
    nfft = _next_pow2(2 * n)
    power = _power(x, nfft)
    if nfft == 2 * n:
        half = power[..., ::2]
    else:
        half = _power(x, n)
    ac = torch.fft.irfft(power, n=nfft, dim=-1)[..., :n_coeffs].to(x.dtype)
    if quirk:
        ac = _quirk(ac, x, n_coeffs)
    return half, ac


def autocorrelate(
    x: torch.Tensor, n_coeffs: int | None = None, quirk: bool = True,
    backend: str | None = None,
) -> torch.Tensor:
    """Autocorrelation along the last axis: (..., n) -> (..., n_coeffs).

    n_coeffs must be <= n, as in the reference (periodic.rs:281). quirk=False
    gives the textbook linear autocorrelation.
    """
    _check_backend(backend)
    n = x.shape[-1]
    if n_coeffs is None:
        n_coeffs = n
    if n_coeffs > n:
        raise ValueError(f"n_coeffs ({n_coeffs}) must be <= frame length ({n})")
    nfft = _next_pow2(2 * n)
    ac = torch.fft.irfft(_power(x, nfft), n=nfft, dim=-1)[..., :n_coeffs].contiguous()
    if quirk:
        ac = _quirk(ac, x, n_coeffs)
    return ac
