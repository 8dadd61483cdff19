"""Batched autocorrelation with the reference's seed quirk.

Port of voxtpu.autocorr. The reference (periodic.rs:276-289) seeds its
accumulator with x[0] and skips the i=0 term, so

    r[lag] = AC_true[lag] - x[0]*x[lag] + x[0]

which is applied here as a closed-form correction after the transform.

Backends:
- "ct_fused": kernel E (voxtpu_torch.ops.ct_fused) computes the power
  spectrum and the lags in one pass. It is what `backend=None` picks when
  the shape passes `ct_fused_supported` (nfft == 2n, n a power of two
  >= 128, up to `MAX_N`), as voxtpu picks it on a TPU; for
  CPU tensors the kernel's plain version runs.
- "fft": torch.fft (rfft -> |.|^2 -> irfft). Every other shape takes it, by
  the gate alone and before any launch; an explicit "ct_fused" request for
  such a shape takes it too, as in voxtpu.
- "ct" (voxtpu's XLA matmul chain) and "ct_fused_x3" (its 3-pass bf16
  variant) are not ported and raise.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops.ct_fused import ct_fused_power_ac, ct_fused_supported

__all__ = ["autocorrelate", "power_and_autocorrelate"]

_BACKENDS = frozenset(["fft", "ct_fused"])
_NOT_PORTED = frozenset(["ct", "ct_fused_x3"])


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _backend(backend: str | None, n: int, nfft: int, dtype: torch.dtype) -> str:
    """The branch that runs: "ct_fused" or "fft"."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(f"autocorrelation backend {backend!r} is not yet ported")
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {sorted(_BACKENDS)}")
    if backend != "fft" and ct_fused_supported(n, nfft, dtype):
        return "ct_fused"
    return "fft"


def _power(x: torch.Tensor, nfft: int) -> torch.Tensor:
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    return (spec.real.square() + spec.imag.square()).to(x.dtype)


def _quirk(ac: torch.Tensor, x: torch.Tensor, n_coeffs: int) -> torch.Tensor:
    x0 = x[..., :1]
    return ac - x0 * x[..., :n_coeffs] + x0


def _fused(x: torch.Tensor, nfft: int, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E over (..., n) frames: (half (..., n//2+1), ac (..., n_coeffs))."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    half, ac = ct_fused_power_ac(x.reshape(-1, n), nfft)
    return half.reshape(lead + (n // 2 + 1,)), ac[:, :n_coeffs].reshape(lead + (n_coeffs,))


def power_and_autocorrelate(
    x: torch.Tensor, n_coeffs: int | None = None, quirk: bool = True,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation plus the n-point half power spectrum.

    Returns (half_power (..., n//2+1), ac (..., n_coeffs)). For power-of-two
    frames nfft == 2n and the half spectrum is the even bins of the 2n-point
    one; otherwise a second n-point transform gives it (voxtpu's cold path).
    """
    n = x.shape[-1]
    if n_coeffs is None:
        n_coeffs = n
    nfft = _next_pow2(2 * n)
    if _backend(backend, n, nfft, x.dtype) == "ct_fused":
        half, ac = _fused(x, nfft, n_coeffs)
    else:
        power = _power(x, nfft)
        half = power[..., ::2] if nfft == 2 * n else _power(x, n)
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
    n = x.shape[-1]
    if n_coeffs is None:
        n_coeffs = n
    if n_coeffs > n:
        raise ValueError(f"n_coeffs ({n_coeffs}) must be <= frame length ({n})")
    nfft = _next_pow2(2 * n)
    if _backend(backend, n, nfft, x.dtype) == "ct_fused":
        _, ac = _fused(x, nfft, n_coeffs)
    else:
        ac = torch.fft.irfft(_power(x, nfft), n=nfft, dim=-1)[..., :n_coeffs].contiguous()
    if quirk:
        ac = _quirk(ac, x, n_coeffs)
    return ac
