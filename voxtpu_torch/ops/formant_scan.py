"""Kernel D: the McCandless formant-slot tracker scanned over frames
(csrc/formant_scan.cu; replaces voxtpu/ops/formant_scan_pallas.py's
`mccandless_scan_pallas`).

`formant_scan_plain` is the PyTorch version: a Python loop of
`voxtpu_torch.formants.estimate_formants_step` over frames, as voxtpu's
`lax.scan`. `formant_scan` runs it for CPU tensors and launches the kernel,
one thread per recording, for CUDA tensors. Both are exact: the step only
compares and copies values.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import kernels

__all__ = ["formant_scan_plain", "formant_scan"]

_MAX_L = 16  # csrc/formant_scan.cu kMaxL


def _check_file_len(F: int, file_len: int | None) -> int:
    file_len = F if file_len is None else int(file_len)
    if file_len < 1 or F % file_len:
        raise ValueError(f"F={F} is not a multiple of file_len={file_len}")
    return file_len


def formant_scan_plain(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
    file_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track res_* (F, R) from the seed est_* (L,): returns the per-frame
    estimate snapshots (F, L) x 2. With file_len, F holds F / file_len
    recordings back to back and the carry resets to the seed at each one's
    first frame."""
    from voxtpu_torch.formants import estimate_formants_step

    F = res_freq.shape[0]
    file_len = _check_file_len(F, file_len)
    L = est_freq.shape[-1]
    out_f = torch.empty((F, L), dtype=res_freq.dtype, device=res_freq.device)
    out_b = torch.empty_like(out_f)
    ef, eb = est_freq, est_bw
    for t in range(F):
        if t % file_len == 0:
            ef, eb = est_freq, est_bw
        ef, eb = estimate_formants_step(ef, eb, res_freq[t], res_bw[t])
        out_f[t] = ef
        out_b[t] = eb
    return out_f, out_b


def formant_scan(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
    file_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`formant_scan_plain` for CPU tensors; on the card, csrc/formant_scan.cu."""
    if kernels.on_cpu(res_freq, res_bw, est_freq, est_bw):
        return formant_scan_plain(res_freq, res_bw, est_freq, est_bw, file_len=file_len)
    F, R = res_freq.shape
    L = est_freq.shape[-1]
    if res_bw.shape != res_freq.shape or est_freq.shape != (L,) or est_bw.shape != (L,) or not 1 <= L <= _MAX_L:
        raise ValueError(
            f"formant_scan: res_* (F, R), est_* (L <= {_MAX_L},); got "
            f"{res_freq.shape}, {res_bw.shape}, {est_freq.shape}, {est_bw.shape}"
        )
    dt = res_freq.dtype
    if not all(t.dtype == dt for t in (res_bw, est_freq, est_bw)):
        raise TypeError("formant_scan: all inputs must share a dtype")
    file_len = _check_file_len(F, file_len)
    args = [t.contiguous() for t in (res_freq, res_bw, est_freq, est_bw)]
    out_f = torch.empty((F, L), dtype=dt, device=res_freq.device)
    out_b = torch.empty_like(out_f)
    kernels.launch("vt_formant_scan", dt, *args, out_f, out_b, F, R, L, file_len)
    formant_scan.launches += 1
    return out_f, out_b


formant_scan.launches = 0
