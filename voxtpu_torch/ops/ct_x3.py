"""Kernel X3: the half power spectrum and the autocorrelation lags of
(B, n) frames as the four-step Cooley-Tukey decomposition on the tensor
cores, each float32 matmul as three bfloat16 products (csrc/ct_x3.cu;
replaces the `algorithm="x3"` body of voxtpu/ops/ct_fused_pallas.py's
`ct_fused_power_ac`, its `pallas_call` at ct_fused_pallas.py:222).

Every matmul splits both operands into bfloat16 hi = bf16(v) and
lo = bf16(v - hi) and sums hi.hi + hi.lo + lo.hi with float32
accumulation: three passes where a float32 product takes six, dropping
only lo.lo (about 2^-32 of the product). The result is within a few 1e-6
of the float64 transform, relative to each output's scale: an opt-in
backend ("ct_fused_x3"), never the default.

`ct_x3_power_ac_plain` is the PyTorch version: ops/ct_fft.py's chain
over its tables, every product three-pass (`_dot3`), in the input's
dtype (float64 too, as voxtpu's interpret mode runs it). `ct_x3_power_ac`
runs it for CPU tensors and launches the kernel for CUDA tensors; the
kernel takes float32 only, and float64 on the card raises.
`ct_x3_supported` is voxtpu's shape gate for the fused kernel.
"""

from __future__ import annotations

import functools

import torch

from voxtpu_torch.device import constant
from voxtpu_torch.ops import kernels
from voxtpu_torch.ops.ct_fft import N2, _fwd_table, _inv_table, ct_autocorr, ct_half_power, ct_power

__all__ = ["ct_x3_supported", "ct_x3_power_ac_plain", "ct_x3_power_ac"]

# The largest n voxtpu's gate admits: its static VMEM footprint of a grid
# cell of 8 frames within 12 MiB (ct_fused_pallas.py:79-89); csrc/ct_x3.cu's
# kMaxN.
_MAX_N = 20608


def ct_x3_supported(n: int, nfft: int) -> bool:
    """voxtpu's gate: nfft == 2n, n a multiple of 128 from 128 to 20,608.
    The same in both dtypes; the kernel itself takes float32 only."""
    n, nfft = int(n), int(nfft)
    return nfft == 2 * n and n % N2 == 0 and N2 <= n <= _MAX_N


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (bf16(t), bf16(t - hi)), both back in t's dtype."""
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi, (t - hi).to(torch.bfloat16).to(t.dtype)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as hi.hi + hi.lo + lo.hi: each product of two bfloat16 values
    is exact in float32, the sums round in the operands' dtype."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def ct_x3_power_ac_plain(x: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) frames -> (half (B, n//2+1), ac (B, n)) by the decomposition
    with three-pass products, in x's dtype on x's device."""
    n = x.shape[-1]
    if not ct_x3_supported(n, nfft):
        raise ValueError(f"ct_x3_power_ac: unsupported shape {tuple(x.shape)}, nfft={nfft}")
    p = ct_power(x, nfft, mm=_dot3)
    return ct_half_power(p, n // 2 + 1).contiguous(), ct_autocorr(p, n, mm=_dot3)


def _pairs(t: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K/2, N, 2): the right operand of a product with each
    column's (k, k+1) neighbours side by side, one 32-bit load a pair."""
    K, N = t.shape
    return t.reshape(K // 2, 2, N).transpose(1, 2)


@functools.lru_cache(maxsize=16)
def _device_tables(n: int, nfft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's tables on the card, made once for each (n, nfft,
    device) from ops/ct_fft.py's: the products' operands split into
    bfloat16 hi and lo on the device, (hi, lo) of c1, s1, c2, s2, -s2, ca,
    sa, cc, -sc in one buffer (c1, s1 as (k1, n1) with an even row length,
    zero-padded; c2 .. sa in column pairs, `_pairs`; cc, sc as (l2, k1)),
    and the twiddles tc, ts as (k1, n2) and the inverse's cb, sb in
    float32 in another (csrc/ct_x3.cu's Tables)."""
    fwd = [constant(_fwd_table, nfft, n, i, dtype=torch.float32, device=device) for i in range(6)]
    inv = [constant(_inv_table, nfft, n, i, dtype=torch.float32, device=device) for i in range(6)]
    c1, s1, c2, s2, tc, ts = fwd[0].T, fwd[1].T, fwd[2], fwd[3], fwd[4].T, fwd[5].T
    ca, sa, cb, sb, cc, sc = inv[0], inv[1], inv[2], inv[3], inv[4].T, inv[5].T
    pad = (n // N2) % 2
    parts = []
    for name, m in (("c1", c1), ("s1", s1), ("c2", c2), ("s2", s2), ("ns2", -s2),
                    ("ca", ca), ("sa", sa), ("cc", cc), ("nsc", -sc)):
        if name in ("c1", "s1") and pad:
            m = torch.nn.functional.pad(m, (0, pad))
        hi = m.to(torch.bfloat16)
        lo = (m - hi.float()).to(torch.bfloat16)
        if name in ("c2", "s2", "ns2", "ca", "sa"):
            hi, lo = _pairs(hi), _pairs(lo)
        parts += [hi.reshape(-1), lo.reshape(-1)]
    f32 = torch.cat([t.reshape(-1) for t in (tc, ts, cb, sb)])
    return torch.cat(parts).contiguous(), f32.contiguous()


def ct_x3_power_ac(x: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`ct_x3_power_ac_plain` for CPU tensors; on the card, csrc/ct_x3.cu
    over (B, n) float32 frames, one block a frame. Both raise for a shape
    that fails `ct_x3_supported`; the card raises for float64."""
    if not ct_x3_supported(x.shape[-1], nfft):
        raise ValueError(f"ct_x3_power_ac: unsupported shape {tuple(x.shape)}, nfft={nfft}")
    if kernels.on_cpu(x):
        return ct_x3_power_ac_plain(x, nfft)
    if x.dtype != torch.float32:
        raise ValueError(f"ct_x3_power_ac: kernel X3 takes float32 only on the card (three bfloat16 passes "
                         f"reach about 3e-6 of scale), got {x.dtype}; use backend 'fft' or 'ct_fused' for float64")
    if x.dim() != 2:
        raise ValueError(f"ct_x3_power_ac: x (B, n) on the card, got {tuple(x.shape)}")
    B, n = x.shape
    x = x.contiguous()
    bf16, f32 = _device_tables(n, nfft, x.device)
    half = torch.empty((B, n // 2 + 1), dtype=x.dtype, device=x.device)
    ac = torch.empty((B, n), dtype=x.dtype, device=x.device)
    kernels.launch("vt_ct_x3", x.dtype, x, bf16, f32, half, ac, B, n)
    ct_x3_power_ac.launches += 1
    return half, ac


ct_x3_power_ac.launches = 0
