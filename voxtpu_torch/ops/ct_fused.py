"""Kernel E: the half power spectrum and the autocorrelation lags of
(B, n) frames in one pass (csrc/ct_fused.cu; replaces
voxtpu/ops/ct_fused_pallas.py's `ct_fused_power_ac`).

`ct_fused_power_ac_plain` is the PyTorch version: rfft to 2n points, power,
irfft. `ct_fused_power_ac` runs it for CPU tensors and launches the kernel
for CUDA tensors: the real frame packed into n/2 complex points and two
n-point complex transforms. A power-of-two n runs radix-16 passes in
registers, 16 complex values a thread; a frame longer than one block holds
(8192 in float32, 4096 in float64) spreads over a thread-block cluster of
n / that blocks, each one residue class of the spectrum. Any other n,
N1 x m with N1 a power of two and m odd, runs a prime-factor split: the
m-point DFTs as products with the DFT matrix on the tensor cores (float32
in three TF32 passes, float64 on the FP64 tensor cores) and N1-point
radix-16 FFTs over a buffer of the whole frame, in shared memory, or in
float64 above 14,336 points in a scratch buffer in device memory
(`ct_fused_layout`); persistent blocks walk the frames, the next frame's
input staged in shared memory by a bulk copy where it fits
(`ct_fused_pfa_staged`). `ct_fused_supported` is the shape gate,
voxtpu's: which shapes the kernel takes follows from (n, nfft, dtype)
alone, never from a failed launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from voxtpu_torch.ops import kernels
from voxtpu_torch.ops.ct_x3 import _MAX_N

__all__ = ["SMEM_LIMIT", "MAX_N", "ct_fused_cluster", "ct_fused_layout", "ct_fused_pfa_staged",
           "ct_fused_smem_bytes", "ct_fused_supported", "ct_fused_power_ac_plain", "ct_fused_power_ac"]

SMEM_LIMIT = 232448  # bytes of shared memory one block may have on an H100 (227 KB; csrc/ct_fused.cu kSmemLimit)
# The largest frame the kernel takes, per dtype (csrc/ct_fused.cu's kMaxN):
# voxtpu's gate, whose VMEM budget stops at 128 x 161 = 20,608 (the power
# of two frames stop at 16,384, kMaxLog2). Fixed, so that which frames take
# the kernel and which take cuFFT does not depend on the kernel's
# shared-memory use.
MAX_N = {torch.float32: _MAX_N, torch.float64: _MAX_N}
# The largest power-of-two frame one block holds (kBlockLog2F32,
# kBlockLog2F64); a longer one takes a cluster of n / this blocks.
_BLOCK_N = {torch.float32: 8192, torch.float64: 4096}
_POINTS = 16  # complex values a thread holds (csrc/ct_fused.cu's kPoints)
_MIN_BLOCK_THREADS = 128  # frames of fewer than 2048 points share a block up to this (kMinBlockThreads)
# The prime-factor kernel's threads a block (kPfaThreads; kPfaWideThreads in
# float32 where N1 >= 2^kPfaWideLog2), and the N tiles of 8 that a warp's
# accumulators hold in its forward and inverse m-point DFTs (kPfaChunk,
# kPfaChunk5).
_PFA_THREADS = 256
_PFA_WIDE_THREADS = 512
_PFA_WIDE_LOG2 = 11
_PFA_CHUNK = 2
_PFA_CHUNK5 = 4


def _pow2(n: int) -> bool:
    return n & (n - 1) == 0


def ct_fused_cluster(n: int, dtype: torch.dtype) -> int:
    """Blocks a frame of n takes: 1 up to the largest power-of-two frame one
    block holds, n / that above it (a thread-block cluster of 2 or 4); 1
    for a frame that is not a power of two."""
    n = int(n)
    return max(1, n // _BLOCK_N[dtype]) if _pow2(n) else 1


def _odd_part(n: int) -> int:
    return n // (n & -n)


def ct_fused_layout(n: int, dtype: torch.dtype) -> str:
    """Where a frame's buffer lives: "registers" for a power of two (its
    values in registers, exchanged through shared memory); else "shared",
    or "device" where its n + m complex values (the frame and the m roots
    of unity, n = N1 m) outgrow SMEM_LIMIT: float64 above 14,336 points."""
    n = int(n)
    if _pow2(n):
        return "registers"
    itemsize = 8 if dtype == torch.float64 else 4
    return "shared" if (n + _odd_part(n)) * 2 * itemsize <= SMEM_LIMIT else "device"


def ct_fused_pfa_staged(n: int, dtype: torch.dtype) -> bool:
    """Whether the prime-factor kernel stages each frame's n/2 input points
    in shared memory (a bulk copy of the next frame while the current one
    runs; csrc/ct_fused.cu's `pfa_staged`): in the "shared" layout, where
    the staged block still fits SMEM_LIMIT."""
    n = int(n)
    if _pow2(n) or ct_fused_layout(n, dtype) != "shared":
        return False
    itemsize = 8 if dtype == torch.float64 else 4
    return (n + n // 2 + _odd_part(n)) * 2 * itemsize + 8 <= SMEM_LIMIT


def _pfa_threads(n: int, dtype: torch.dtype) -> int:
    """Threads a block of the prime-factor kernel at a frame of n = N1 m
    (csrc/ct_fused.cu's PfaPlan): 512 in float32 where N1 >= 2048, else 256."""
    n = int(n)
    wide = dtype == torch.float32 and (n & -n) >= 1 << _PFA_WIDE_LOG2
    return _PFA_WIDE_THREADS if wide else _PFA_THREADS


def ct_fused_smem_bytes(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: each of its frames' exchange
    buffer of n complex values, or of n / cluster in a cluster's block; for
    a frame that is not a power of two, n = N1 m, the frame and the m roots
    of unity, or the roots alone in the "device" layout, and where the input
    is staged (`ct_fused_pfa_staged`) its n/2 points and an 8-byte mbarrier
    (csrc/ct_fused.cu)."""
    n = int(n)
    itemsize = 8 if dtype == torch.float64 else 4
    layout = ct_fused_layout(n, dtype)
    if layout != "registers":
        staged = ct_fused_pfa_staged(n, dtype)
        points = (n if layout == "shared" else 0) + (n // 2 if staged else 0) + _odd_part(n)
        return points * 2 * itemsize + (8 if staged else 0)
    m = n // ct_fused_cluster(n, dtype)
    frames = max(1, _MIN_BLOCK_THREADS // (m // _POINTS))
    return frames * m * 2 * itemsize


def ct_fused_supported(n: int, nfft: int, dtype: torch.dtype) -> bool:
    """The kernel takes nfft == 2n, n a multiple of 128 from 128 to MAX_N
    (20,608 in either dtype): voxtpu's gate (ct_fused_pallas.py:79-89)."""
    n, nfft = int(n), int(nfft)
    return dtype in MAX_N and nfft == 2 * n and n % 128 == 0 and 128 <= n <= MAX_N[dtype]


def ct_fused_power_ac_plain(x: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) frames -> (half (B, n//2+1), ac (B, n)): the n-point rfft power
    bins, which are the even bins of the nfft-point ones, and the first n
    lags of irfft(|rfft(x, nfft)|^2)."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    power = (spec.real.square() + spec.imag.square()).to(x.dtype)
    ac = torch.fft.irfft(power, n=nfft, dim=-1)[..., :n].to(x.dtype)
    return power[..., ::2].contiguous(), ac.contiguous()


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(n, 2): cos and -sin of 2 pi k / 2n, k < n, built in float64, one
    (re, im) pair a row."""
    ang = 2.0 * np.pi * np.arange(n) / (2 * n)
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=-1), dtype=dtype, device=device)


def ct_fused_power_ac(x: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`ct_fused_power_ac_plain` for CPU tensors; on the card, csrc/ct_fused.cu
    over (B, n) frames. Both raise for a shape that fails
    `ct_fused_supported`."""
    if not ct_fused_supported(x.shape[-1], nfft, x.dtype):
        raise ValueError(f"ct_fused_power_ac: unsupported shape {tuple(x.shape)}, nfft={nfft}, {x.dtype}")
    if kernels.on_cpu(x):
        return ct_fused_power_ac_plain(x, nfft)
    if x.dim() != 2:
        raise ValueError(f"ct_fused_power_ac: x (B, n) on the card, got {tuple(x.shape)}")
    B, n = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads (x[2m], x[2m+1]) pairs as one vector
        x = x.clone()
    half = torch.empty((B, n // 2 + 1), dtype=x.dtype, device=x.device)
    ac = torch.empty((B, n), dtype=x.dtype, device=x.device)
    scratch, blocks = 0, 0
    if ct_fused_layout(n, x.dtype) == "device":
        # A frame's buffer for each block, one block an SM (its 256 threads
        # take up to 255 registers each), the blocks walking the frames.
        blocks = max(1, min(B, torch.cuda.get_device_properties(x.device).multi_processor_count))
        scratch = torch.empty((blocks, n, 2), dtype=x.dtype, device=x.device)
    kernels.launch("vt_ct_fused", x.dtype, x, _twiddles(n, x.dtype, x.device), half, ac, scratch, B, n, blocks)
    ct_fused_power_ac.launches += 1
    return half, ac


ct_fused_power_ac.launches = 0
