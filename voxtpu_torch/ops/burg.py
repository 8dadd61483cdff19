"""Kernel B: Burg LPC per frame (csrc/burg.cu; replaces
voxtpu/ops/burg_pallas.py's `burg_pallas`).

`burg_plain` is the PyTorch version of `voxtpu.lpc.burg` (the reference's
lpc_praat_mut, spectrum.rs:101-146), batched over frames with the order
recursion unrolled. `burg` runs it for CPU tensors, at any order, and launches the kernel,
one thread block per frame, for CUDA tensors, at orders up to 127 (as
voxtpu's Pallas kernel, voxtpu/ops/burg_pallas.py:87-88).

Both accumulate each order's two sums (num, denum) and its reflection
coefficient in float64, also for float32 frames; b1, b2 and the coefficients
stay in the frames' dtype. A float32 sum over a frame of 2205 samples lands
on a value that depends on the summation order, and Burg's coefficients,
and the formants from their roots, are sensitive to it: with float32 sums, the
kernel and this version, each summing in its own order, put one formant of
the 44.1 kHz CLI default slice over 1.4 Hz apart (NVIDIA H100 80GB HBM3,
700 W). In float64 the order no longer shows in the float32 result.

The kernel holds each frame in registers: thread t takes pairs [t c, t c +
c) of (b1, b2), and an order costs one block barrier. `launch_config` is the
pure function of (n, dtype) that picks the layout, the threads and the
width c; the kernel's constants are mirrored here. Frames too long for the
registers of a block's 512 threads (over 35 x 512 pairs in float32, 23 x 512
in float64) run the same steps with the rows in shared memory (the "shared"
layout), up to the card's shared memory a block (28,967 float32 and 14,497
float64 samples); longer ones over a thread-block cluster of 2, 4 or 8
blocks, each holding a contiguous share of the pairs in its shared memory
(the "cluster" layout; the warps exchange their sums through each block's
shared memory, one record set an order), up to 225,793 float32
and 112,897 float64 samples; longer ones still with the rows in a scratch
buffer in device memory that the wrapper allocates (the "device" layout,
512 threads at the width that holds the frame), so the card takes every
frame length.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from voxtpu_torch import errors
from voxtpu_torch.ops import kernels

__all__ = ["BurgConfig", "ROWS", "burg_plain", "burg", "launch_config", "layout", "smem_bytes"]

# Mirrors of csrc/burg.cu's constants.
_MAX_ORDER = 127  # kMaxOrder
_WIDTH = {torch.float32: 35, torch.float64: 23}  # kWidthF32, kWidthF64
_SHARED_WIDTH = 63  # kSharedWidth
_MAX_THREADS = 512  # kMaxThreads
_SMEM_LIMIT = 232448  # kSmemLimit
_CLUSTERS = (2, 4, 8)  # the cluster layout's blocks a frame, up to kMaxCluster
# Where the rows live, as the launcher's `rows` argument (kRowsRegisters,
# kRowsShared, kRowsDevice, kRowsCluster).
ROWS = {"registers": 0, "shared": 1, "device": 2, "cluster": 3}


class BurgConfig(NamedTuple):
    """A launch of kernel B: where the rows live ("registers", "shared",
    "cluster" or "device"), threads a block, pairs a thread, and blocks a
    frame (a thread-block cluster of them in the cluster layout, else 1)."""

    rows: str
    threads: int
    width: int
    blocks: int = 1


def _threads(n: int, width: int) -> int:
    """The fewest whole warps whose threads hold n - 1 pairs, width each."""
    threads = -(-(n - 1) // width)
    return -(-threads // 32) * 32


def smem_bytes(n: int, dtype: torch.dtype, config: BurgConfig) -> int:
    """csrc/burg.cu smem_bytes: the rows (n values staged, b1 and b2 of
    n - 1 values each, the block's share of b1 and b2 of threads x width
    values each in the cluster layout, or none when they lie in device
    memory), rounded to 16 bytes, then two parities of the warps' (num, den)
    in double and first pairs in the dtype; in the cluster layout two
    mbarriers and two sets of the cluster's records, (num, den) and the
    first pair of each of its warps."""
    return _smem(n, dtype.itemsize, config.rows, config.threads, config.blocks)


def _smem(n: int, itemsize: int, rows: str, threads: int, blocks: int = 1) -> int:
    values = (n if rows == "registers" else 2 * (n - 1) if rows == "shared"
              else 2 * threads * _SHARED_WIDTH if rows == "cluster" else 0)
    warps = threads // 32
    if rows == "cluster":
        return -(-values * itemsize // 16) * 16 + 16 + 4 * blocks * warps * (8 + itemsize)
    return -(-values * itemsize // 16) * 16 + 4 * warps * 8 + 4 * warps * itemsize


def _fits(n: int, itemsize: int, rows: str, threads: int, blocks: int = 1) -> bool:
    return threads <= _MAX_THREADS and _smem(n, itemsize, rows, threads, blocks) <= _SMEM_LIMIT


def layout(n: int, dtype: torch.dtype, rows: str) -> BurgConfig | None:
    """The launch of kernel B for frames of n `dtype` values with the rows in
    registers or shared memory, at the fewest whole warps that hold them
    (None where that takes more than a block's threads or shared memory);
    over a cluster of the fewest blocks (2, 4 or 8) whose shares of the
    pairs, at the fewest whole warps that hold them, fit a block (None where
    8 do not); or in device memory, at 512 threads and the width that holds
    them."""
    if dtype not in _WIDTH:
        raise TypeError(f"burg: kernels take float32 or float64, got {dtype}")
    if rows == "device":
        return BurgConfig(rows, _MAX_THREADS, max(1, -(-(n - 1) // _MAX_THREADS)))
    if rows == "cluster":
        for blocks in _CLUSTERS:
            threads = _threads(-(-(n - 1) // blocks) + 1, _SHARED_WIDTH)
            if _fits(n, dtype.itemsize, rows, threads, blocks):
                return BurgConfig(rows, threads, _SHARED_WIDTH, blocks)
        return None
    width = _SHARED_WIDTH if rows == "shared" else _WIDTH[dtype]
    threads = _threads(n, width)
    return BurgConfig(rows, threads, width) if _fits(n, dtype.itemsize, rows, threads) else None


@functools.cache
def _tops(dtype: torch.dtype) -> tuple[int, int, int]:
    """The longest frames the registers, shared memory and a cluster hold
    (each layout holds every shorter frame too)."""

    def top(rows: str) -> int:
        lo, hi = 2, 1 << 24
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if layout(mid, dtype, rows) else (lo, mid - 1)
        return lo

    return top("registers"), top("shared"), top("cluster")


def launch_config(n: int, dtype: torch.dtype) -> BurgConfig:
    """Kernel B's launch for (B, n) frames of `dtype`, a pure function of
    (n, dtype): the rows in registers where a block holds them, else in
    shared memory, else over a thread-block cluster, else in device memory."""
    if dtype not in _WIDTH:
        raise TypeError(f"burg: kernels take float32 or float64, got {dtype}")
    registers, shared, cluster = _tops(dtype)
    rows = "registers" if n <= registers else "shared" if n <= shared else "cluster" if n <= cluster else "device"
    return layout(n, dtype, rows)


def burg_plain(x: torch.Tensor, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Burg LPC of (..., N) frames: (coeffs (..., P) sign-flipped as in the
    reference, status (...,) int32 with LPC_DENUM_NONPOS where an order hit
    denum <= 0; such frames divide by 1 there and keep best-effort values)."""
    n = x.shape[-1]
    p = int(n_coeffs)
    if n < 2:
        raise ValueError("burg needs at least 2 samples per frame")
    batch = x.shape[:-1]
    zeros1 = torch.zeros(batch + (1,), dtype=x.dtype, device=x.device)
    # b1 = [x[0] .. x[n-2], 0], b2 = [x[1] .. x[n-1], 0]
    b1 = torch.cat([x[..., : n - 1], zeros1], dim=-1)
    b2 = torch.cat([x[..., 1:], zeros1], dim=-1)

    coeffs = torch.zeros(batch + (p,), dtype=x.dtype, device=x.device)
    aa = torch.zeros_like(coeffs)
    status = torch.zeros(batch, dtype=torch.int32, device=x.device)
    for i in range(1, p + 1):
        m = n - i  # active samples this order
        # num, denum and ci in float64 for every dtype, as the kernel does.
        u, v = b1[..., :m].double(), b2[..., :m].double()
        num = torch.sum(u * v, dim=-1)
        denum = torch.sum(u**2 + v**2, dim=-1)
        bad = denum <= 0
        status = torch.where(bad, status | errors.LPC_DENUM_NONPOS, status)
        ci = (2.0 * num / torch.where(bad, torch.ones_like(denum), denum)).to(x.dtype)

        # coeffs[i-1] = ci; coeffs[j-1] = aa[j-1] - ci * aa[i-j-1], j < i
        head = aa[..., : i - 1] - ci[..., None] * aa[..., : i - 1].flip(-1)
        coeffs = torch.cat([head, ci[..., None], coeffs[..., i:]], dim=-1)
        if i < p:
            aa = torch.cat([coeffs[..., :i], aa[..., i:]], dim=-1)
            c = ci[..., None]
            # b2[k] reads the pre-update b1[k+1] (spectrum.rs:135-138).
            b1, b2 = (
                b1 - c * b2,
                torch.cat([b2[..., 1:], zeros1], dim=-1) - c * torch.cat([b1[..., 1:], zeros1], dim=-1),
            )
    return -coeffs, status


def burg(x: torch.Tensor, n_coeffs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`burg_plain` for CPU tensors; on the card, csrc/burg.cu over (B, N)
    with `launch_config(N, dtype)`."""
    if kernels.on_cpu(x):
        return burg_plain(x, n_coeffs)
    p = int(n_coeffs)
    if x.dim() != 2 or x.shape[-1] < 2 or p < 1:
        raise ValueError(f"burg: x (B, N >= 2) and an order >= 1; got {x.shape}, {p}")
    if p > _MAX_ORDER:
        raise ValueError(
            f"burg: the card takes LPC orders up to {_MAX_ORDER}, as voxtpu's Pallas kernel "
            f"(voxtpu/ops/burg_pallas.py:87-88); got {p}"
        )
    coef, status = _launch(x.contiguous(), p, launch_config(x.shape[-1], x.dtype))
    burg.launches += 1
    return coef, status


def _launch(x: torch.Tensor, p: int, config: BurgConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/burg.cu over contiguous (B, N) frames at order p with `config`
    (uncounted: `burg` counts its launch; tools/burg_split.py runs the other
    layouts through this). The device layout's rows go in a scratch buffer,
    (B, width, 2, threads): pair t c + j of a frame's (b1, b2) at [j, :, t],
    uninitialised (the kernel fills them from the frames). The cluster
    layout runs B clusters of `config.blocks` blocks."""
    B, N = x.shape
    coef = torch.empty((B, p), dtype=x.dtype, device=x.device)
    status = torch.empty((B,), dtype=torch.int32, device=x.device)
    rows = None
    if config.rows == "device":
        rows = torch.empty((B, config.width, 2, config.threads), dtype=x.dtype, device=x.device)
    kernels.launch("vt_burg", x.dtype, x, coef, status, rows, B, N, p, config.threads, config.width,
                   ROWS[config.rows], config.blocks)
    return coef, status


burg.launches = 0
