"""Peaks of one H100 and the least time a kernel's work could take.

Copied from `chip_smoke.py` (`bound`, `burg_bound` without its conversion
rate, `viterbi_bound`) and taking shapes, not tensors, so that a metric
reader can count the real frames of a block alone: padding frames are work
the function does not need, so they show as waste.
"""

from __future__ import annotations

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bytes/s and FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12


def bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """The least seconds for the work: the larger of its bytes over the
    memory rate and its operations' seconds at the compute rate."""
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_bytes, ops_s), ("bytes" if t_bytes >= ops_s else "operations")


def burg_bound(frames: int, n: int, p: int, isz: int = 4) -> tuple[float, str]:
    """Kernel B at `frames` frames of n samples and order p: it reads the
    frames once and writes (frames, p) coefficients and a status a frame.
    Each order i sums num and denum over n - i pairs in float64 (6
    operations a pair) and, below p, updates n - i pairs in the frames'
    dtype (4)."""
    summed = sum(n - i for i in range(1, p + 1)) * frames
    updated = sum(n - i for i in range(1, p)) * frames
    nbytes = frames * n * isz + frames * (p * isz + 4)
    ops_s = 6.0 * summed / F64_OPS_S + 4.0 * updated / (F32_OPS_S if isz == 4 else F64_OPS_S)
    return bound(nbytes, ops_s)


def viterbi_bound(frames: int, C: int, isz: int = 4) -> tuple[float, str]:
    """Kernel F at `frames` frame steps (summed over recordings) of C
    candidates: C^2 costs a step (division, log2, |.|, product, difference
    and compare: 6 operations); it reads the local scores, frequencies and
    voiced flags once and writes the path."""
    ops = frames * C * C * 6
    nbytes = frames * C * (2 * isz + 1) + frames * 4
    return bound(nbytes, ops / (F32_OPS_S if isz == 4 else F64_OPS_S))
