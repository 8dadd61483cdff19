"""Kernel F: the Viterbi pitch-path DP and its backtrace (csrc/viterbi.cu;
replaces voxtpu/ops/viterbi_pallas.py's `viterbi_path_pallas`).

`viterbi_path_plain` is the PyTorch version: the DP of
voxtpu.viterbi.pitch_path (viterbi.py:110-151) as a Python loop over frames,
batched over a leading recordings axis. `viterbi_path` runs it for CPU
tensors and launches the kernel, one thread block per recording, for CUDA
tensors. Paths are bit-identical: both compute every cost in the same op
order (the frequency ratio before log2) and break ties to the first winner.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import kernels

__all__ = ["viterbi_path_plain", "viterbi_path"]

_MAX_C = 128  # csrc/viterbi.cu kMaxC


def _batched(local, freq, voiced):
    if local.dim() == 2:
        return local[None], freq[None], voiced[None], True
    return local, freq, voiced, False


def viterbi_path_plain(
    local: torch.Tensor, freq: torch.Tensor, voiced: torch.Tensor, ojc: float, vuc: float,
) -> torch.Tensor:
    """Maximum-score path through per-frame candidates.

    local: (F, C) or (B, F, C) local scores, -inf on invalid lanes; freq:
    transition frequencies, `where(voiced, f0, 1.0)`; voiced: bool mask;
    ojc / vuc: octave-jump and voiced/unvoiced costs. Returns the int32
    candidate index per frame, (F,) or (B, F)."""
    local, freq, voiced, squeeze = _batched(local, freq, voiced)
    B, F, C = local.shape
    dev = local.device
    vuc_t = torch.tensor(vuc, dtype=local.dtype, device=dev)
    zero = torch.zeros((), dtype=local.dtype, device=dev)
    score = local[:, 0]
    bp = torch.zeros((B, F, C), dtype=torch.int64, device=dev)
    for t in range(1, F):
        vp, vc = voiced[:, t - 1, :, None], voiced[:, t, None, :]
        jump = torch.abs(torch.log2(freq[:, t - 1, :, None] / freq[:, t, None, :]))
        cost = torch.where(vp & vc, ojc * jump, torch.where(vp ^ vc, vuc_t, zero))
        best, bp[:, t] = torch.max(score[:, :, None] - cost, dim=1)  # (B, prev C, cur C)
        score = local[:, t] + best
    path = torch.empty((B, F), dtype=torch.int64, device=dev)
    c = torch.argmax(score, dim=-1)
    path[:, F - 1] = c
    for t in range(F - 1, 0, -1):
        c = torch.gather(bp[:, t], 1, c[:, None])[:, 0]
        path[:, t - 1] = c
    path = path.to(torch.int32)
    return path[0] if squeeze else path


def viterbi_path(
    local: torch.Tensor, freq: torch.Tensor, voiced: torch.Tensor, ojc: float, vuc: float,
) -> torch.Tensor:
    """`viterbi_path_plain` for CPU tensors; on the card, csrc/viterbi.cu:
    one launch for all B recordings, C <= 128."""
    if kernels.on_cpu(local, freq, voiced):
        return viterbi_path_plain(local, freq, voiced, ojc, vuc)
    local, freq, voiced, squeeze = _batched(local, freq, voiced)
    B, F, C = local.shape
    if freq.shape != local.shape or voiced.shape != local.shape or F < 1 or not 1 <= C <= _MAX_C:
        raise ValueError(
            f"viterbi_path: local/freq/voiced (B, F >= 1, C <= {_MAX_C}) of one shape; got "
            f"{tuple(local.shape)}, {tuple(freq.shape)}, {tuple(voiced.shape)}"
        )
    if freq.dtype != local.dtype or voiced.dtype != torch.bool:
        raise TypeError("viterbi_path: local and freq share a float dtype, voiced is bool")
    args = [t.contiguous() for t in (local, freq, voiced)]
    bp = torch.empty((B, F, C), dtype=torch.int32, device=local.device)
    path = torch.empty((B, F), dtype=torch.int32, device=local.device)
    kernels.launch("vt_viterbi", local.dtype, *args, bp, path, B, F, C, float(ojc), float(vuc))
    viterbi_path.launches += 1
    return path[0] if squeeze else path


viterbi_path.launches = 0
