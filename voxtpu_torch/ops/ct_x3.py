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
`ct_x3_supported` is voxtpu's shape gate for the fused kernel; every n it
admits runs the one kernel, in tiles of 64 k1 rows (`_layout`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from voxtpu_torch.ops import kernels
from voxtpu_torch.ops.ct_fft import N2, _fwd_tables_np, _inv_tables_np, ct_autocorr, ct_half_power, ct_power

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


# The kernel's tiling (csrc/ct_x3.cu): k1 rows a tile (one product's M),
# rows of x a chunk (stage 1's K), lag rows a piece of the last product.
_TILE, _CHUNK, _PIECE = 64, 16, 32


def _layout(n: int) -> tuple[int, int, int, int, int, int]:
    """(N1, tiles, chunks, pieces, a8, b8) of an n-sample frame, as
    csrc/ct_x3.cu's shape_of: N1 = 2n/128 k1 rows in tiles of 64, n/128
    rows of x in chunks of 16 and lag rows in pieces of 32, and the a8 x
    b8 table of E(8ab)."""
    rows = n // N2
    tiles = -(-2 * rows // _TILE)
    return 2 * rows, tiles, -(-rows // _CHUNK), -(-rows // _PIECE), max(_TILE * tiles, N2), max(8 * tiles, 16)


def _image(m: torch.Tensor) -> torch.Tensor:
    """(R, K) -> a wgmma operand's shared-memory image, no swizzle,
    K-major: 8 x 8 core matrices of 128 contiguous bytes, the K/8 of an
    8-row group side by side (SBO = K/8 x 128 bytes)."""
    R, K = m.shape
    return m.reshape(R // 8, 8, K // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def _fragments(m: torch.Tensor) -> torch.Tensor:
    """(64, 16) -> a left operand as the registers of 128 threads, 8
    values each: thread 32 w + 4 g + t holds rows 16 w + g (+ 8) and
    columns 2t, 2t + 1 (+ 8), register 2 (column half) + (row half)."""
    return m.reshape(4, 2, 8, 2, 4, 2).permute(0, 2, 4, 3, 1, 5).reshape(-1)


def _split_np(m: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 table's bfloat16 (hi, lo)."""
    t = torch.as_tensor(m, dtype=torch.float32)
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _padded(m: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols))
    out[: m.shape[0], : m.shape[1]] = m
    return out


@functools.lru_cache(maxsize=16)
def _device_tables(n: int, nfft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's tables on the card, made once for each (n, nfft,
    device) from ops/ct_fft.py's float64 ones, every product's operand
    split into bfloat16 hi and lo once, here.

    The bfloat16 buffer holds what the kernel copies into shared memory
    with no change: the images (`_image`) of c2 hi, c2 lo, s2 hi, s2 lo
    (128 x 128, symmetric: stage 3's right operand and, as the inverse's
    cos and -sin tables, its left one, so the inverse's own tables and a
    negated s2 are not stored); c1, s1 (k1, n1) as left-operand register
    fragments (`_fragments`), for each tile of 64 k1 rows and chunk of 16
    n1 columns c1 hi, c1 lo, s1 hi, s1 lo; and cc, sc (k1, l2) as images
    of (l2, k1) pieces, for each tile and piece of 32 lag rows cc hi, cc
    lo, sc hi, sc lo. Tables are zero past N1, n/128 and the lag rows. The
    float32 buffer holds the twiddles' factors as (cos, sin) pairs of
    E(p) = e^{2 pi i p / N}: E(8ab) for a < a8, b < b8, then E(am) for
    m < 8 (`_layout`); csrc/ct_x3.cu multiplies two to get E(k1 n2) and
    E(k1 l1)."""
    _, tiles, chunks, pieces, a8, b8 = _layout(n)
    c1, s1, c2, s2 = _fwd_tables_np(nfft, n)[:4]
    cc, sc = _inv_tables_np(nfft, n)[4:]
    parts = [_image(p) for m in (c2, s2) for p in _split_np(m)]
    c1p = [p for m in (c1.T, s1.T) for p in _split_np(_padded(m, _TILE * tiles, _CHUNK * chunks))]
    parts += [_fragments(p[_TILE * t: _TILE * (t + 1), _CHUNK * c: _CHUNK * (c + 1)])
              for t in range(tiles) for c in range(chunks) for p in c1p]
    ccp = [p for m in (cc, sc) for p in _split_np(_padded(m, _TILE * tiles, _PIECE * pieces))]
    parts += [_image(p[_TILE * t: _TILE * (t + 1), _PIECE * j: _PIECE * (j + 1)].T)
              for t in range(tiles) for j in range(pieces) for p in ccp]
    a = np.arange(a8)[:, None]
    e8, em = (8 * a * np.arange(b8)) % nfft, (a * np.arange(8)) % nfft
    f32 = np.concatenate([np.stack([np.cos(2 * np.pi * p / nfft), np.sin(2 * np.pi * p / nfft)], -1).ravel()
                          for p in (e8, em)])
    return torch.cat(parts).contiguous().to(device), torch.as_tensor(f32, dtype=torch.float32).to(device)


def ct_x3_power_ac(x: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`ct_x3_power_ac_plain` for CPU tensors; on the card, csrc/ct_x3.cu
    over (B, n) float32 frames, one block an SM walking the frames. Both
    raise for a shape that fails `ct_x3_supported`; the card raises for
    float64."""
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
    if x.data_ptr() % 16:  # the kernel copies rows of x in bulk, from 16-byte boundaries
        x = x.clone()
    bf16, f32 = _device_tables(n, nfft, x.device)
    half = torch.empty((B, n // 2 + 1), dtype=x.dtype, device=x.device)
    ac = torch.empty((B, n), dtype=x.dtype, device=x.device)
    kernels.launch("vt_ct_x3", x.dtype, x, bf16, f32, half, ac, B, n)
    ct_x3_power_ac.launches += 1
    return half, ac


ct_x3_power_ac.launches = 0
