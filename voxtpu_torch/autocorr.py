"""Batched autocorrelation with the reference's seed quirk.

Port of voxtpu.autocorr. The reference (periodic.rs:276-289) seeds its
accumulator with x[0] and skips the i=0 term, so

    r[lag] = AC_true[lag] - x[0]*x[lag] + x[0]

which is applied here as a closed-form correction after the transform.

Backends (voxtpu's names; the branch follows from the name and the shape
alone, before any launch):
- "ct_fused": kernel E (voxtpu_torch.ops.ct_fused) computes the power
  spectrum and the lags in one pass. It is what `backend=None` picks when
  the shape passes `ct_fused_supported` (voxtpu's gate: nfft == 2n, n a
  multiple of 128 from 128 to `MAX_N`, 20,608, in either dtype), as voxtpu
  picks it on a TPU; for CPU tensors the kernel's plain version runs. The
  entry points pass nfft = next_pow2(2n), so the frames that reach it from
  them are powers of two up to 16,384 (above 8,192 float32 and 4,096
  float64 samples over a thread-block cluster). The other multiples of 128
  reach kernel E only through `ct_fused_power_ac` itself, which runs its
  prime-factor kernel. An explicit "ct_fused" request for another shape
  takes "fft".
- "ct_fused_x3": kernel X3 (voxtpu_torch.ops.ct_x3), the same
  decomposition as voxtpu's on the tensor cores in three bfloat16 passes,
  about 3e-6 of scale; opt-in. Float32 only on the card (float64 raises);
  the plain version takes both on the CPU. Outside voxtpu's gate
  (`ct_x3_supported`) it takes "ct", then "fft", as voxtpu's does.
- "ct": voxtpu's four-step matmul chain (voxtpu_torch.ops.ct_fft), in
  true float32; "fft" where nfft does not split (or, for the half
  spectrum, nfft != 2n).
- "fft": torch.fft (rfft -> |.|^2 -> irfft). Every other shape takes it.
voxtpu's "_interpret" names are Pallas interpret-mode switches; the port
runs each kernel's plain version for CPU tensors instead, and the names
raise ValueError.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops.ct_fft import ct_autocorr, ct_half_power, ct_power, ct_supported
from voxtpu_torch.ops.ct_fused import ct_fused_power_ac, ct_fused_supported
from voxtpu_torch.ops.ct_x3 import ct_x3_power_ac, ct_x3_supported

__all__ = ["autocorrelate", "power_and_autocorrelate"]

_BACKENDS = frozenset(["fft", "ct", "ct_fused", "ct_fused_x3"])
_INTERPRET = frozenset(["ct_fused_interpret", "ct_fused_x3_interpret"])


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _backend(backend: str | None, n: int, nfft: int, dtype: torch.dtype, half: bool = False) -> str:
    """The branch that runs: "ct_fused", "ct_fused_x3", "ct" or "fft".
    half: the caller also wants the n-point half spectrum, which "ct"
    takes from the even bins only when nfft == 2n."""
    if backend in _INTERPRET:
        raise ValueError(f"unknown backend {backend!r}: voxtpu's Pallas interpret-mode switch; the port runs "
                         f"each kernel's plain version for CPU tensors; one of {sorted(_BACKENDS)}")
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {sorted(_BACKENDS)}")
    ct_ok = ct_supported(nfft) and (nfft == 2 * n or not half)
    if backend == "ct_fused_x3":
        return "ct_fused_x3" if ct_x3_supported(n, nfft) else "ct" if ct_ok else "fft"
    if backend == "ct":
        return "ct" if ct_ok else "fft"
    if backend != "fft" and ct_fused_supported(n, nfft, dtype):
        return "ct_fused"
    return "fft"


def _power(x: torch.Tensor, nfft: int) -> torch.Tensor:
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    return (spec.real.square() + spec.imag.square()).to(x.dtype)


def _quirk(ac: torch.Tensor, x: torch.Tensor, n_coeffs: int) -> torch.Tensor:
    x0 = x[..., :1]
    return ac - x0 * x[..., :n_coeffs] + x0


def _matmul_branch(branch: str, x: torch.Tensor, nfft: int, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E, kernel X3 or the "ct" chain over (..., n) frames:
    (half (..., n//2+1), ac (..., n_coeffs))."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    xb = x.reshape(-1, n)
    if branch == "ct":
        p = ct_power(xb, nfft)
        half, ac = ct_half_power(p, n // 2 + 1), ct_autocorr(p, n_coeffs)
    else:
        half, ac = (ct_fused_power_ac if branch == "ct_fused" else ct_x3_power_ac)(xb, nfft)
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
    branch = _backend(backend, n, nfft, x.dtype, half=True)
    if branch != "fft":
        half, ac = _matmul_branch(branch, x, nfft, n_coeffs)
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
    branch = _backend(backend, n, nfft, x.dtype)
    if branch == "ct":
        ac = ct_autocorr(ct_power(x.reshape(-1, n), nfft), n_coeffs).reshape(x.shape[:-1] + (n_coeffs,))
    elif branch != "fft":
        _, ac = _matmul_branch(branch, x, nfft, n_coeffs)
    else:
        ac = torch.fft.irfft(_power(x, nfft), n=nfft, dim=-1)[..., :n_coeffs].contiguous()
    if quirk:
        ac = _quirk(ac, x, n_coeffs)
    return ac
