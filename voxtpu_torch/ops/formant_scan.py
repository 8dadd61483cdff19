"""Kernel D: the McCandless formant-slot tracker scanned over frames
(csrc/formant_scan.cu; replaces voxtpu/ops/formant_scan_pallas.py's
`mccandless_scan_pallas`).

`formant_scan_plain` is the PyTorch version: a Python loop of
`voxtpu_torch.formants.estimate_formants_step` over frames, as voxtpu's
`lax.scan`. `formant_scan` runs it for CPU tensors and launches the kernel
for CUDA tensors: a chunked speculative scan with exact repair, two device
kernels a call (chunks of CHUNK frames each stepped from the seed after a
WARMUP-frame warm-up, then a pass a recording that re-runs, in order, the
chunks whose entry carry was wrong; past 32 estimates a third writes the
columns that hold their seed in every frame). Both are exact: the step
only compares and copies values, and repair compares carries bit for bit.

`formant_scan_check` checks a scan's output over every frame with one
batched step: it is how a kernel's output is held to the serial scan at
sizes where the Python loop is too slow.
"""

from __future__ import annotations

import torch

from voxtpu_torch.ops import kernels

__all__ = ["CHUNK", "WARMUP", "formant_scan_plain", "formant_scan", "formant_scan_check"]

_MAX_L = 128  # csrc/formant_scan.cu kMaxL: voxtpu's LANES (formant_scan_pallas.py:31)
CHUNK = 64  # csrc/formant_scan.cu kChunk: frames a speculated chunk
WARMUP = 96  # csrc/formant_scan.cu kWarmup: frames stepped from the seed before a chunk
_SPEC = 12  # csrc/formant_scan.cu kSpec: a chunk's entry carry, 6 frequencies and 6 bandwidths


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
    first frame; the loop runs over file_len frames with the recordings as
    the step's batch axis."""
    from voxtpu_torch.formants import estimate_formants_step

    F, R = res_freq.shape
    file_len = _check_file_len(F, file_len)
    files = F // file_len
    L = est_freq.shape[-1]
    rf = res_freq.reshape(files, file_len, R)
    rb = res_bw.reshape(files, file_len, R)
    out_f = torch.empty((files, file_len, L), dtype=res_freq.dtype, device=res_freq.device)
    out_b = torch.empty_like(out_f)
    ef, eb = est_freq.expand(files, L), est_bw.expand(files, L)
    for t in range(file_len):
        ef, eb = estimate_formants_step(ef, eb, rf[:, t], rb[:, t])
        out_f[:, t] = ef
        out_b[:, t] = eb
    return out_f.reshape(F, L), out_b.reshape(F, L)


def formant_scan(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
    file_len: int | None = None, stats: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`formant_scan_plain` for CPU tensors; on the card, csrc/formant_scan.cu.

    stats: for CUDA tensors only, an int64 tensor of 3 on their device that
    the kernel fills with (chunks, chunks re-run, frames re-run in repair)."""
    if kernels.on_cpu(res_freq, res_bw, est_freq, est_bw):
        if stats is not None:
            raise ValueError("formant_scan: stats are counted by the kernel, for CUDA tensors only")
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
    dev = res_freq.device
    if stats is not None and (stats.shape != (3,) or stats.dtype != torch.int64 or stats.device != dev):
        raise ValueError(f"formant_scan: stats must be an int64 tensor of 3 on {dev}")
    args = [t.contiguous() for t in (res_freq, res_bw, est_freq, est_bw)]
    out_f = torch.empty((F, L), dtype=dt, device=dev)
    out_b = torch.empty_like(out_f)
    spec = torch.empty((F // file_len * -(-file_len // CHUNK), _SPEC), dtype=dt, device=dev)
    kernels.launch("vt_formant_scan", dt, *args, out_f, out_b, spec, 0 if stats is None else stats, F, R, L, file_len)
    formant_scan.launches += 1
    return out_f, out_b


formant_scan.launches = 0


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def formant_scan_check(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
    out_f: torch.Tensor, out_b: torch.Tensor, file_len: int | None = None,
) -> torch.Tensor:
    """The frames t (ascending) where a candidate scan output out_* (F, L)
    differs, bit for bit, from one plain step from frame t - 1's output (from
    the seed at each recording's first frame). Empty means, by induction
    from the seed, that out_* equals `formant_scan_plain`'s output. One
    `estimate_formants_step` batched over all F frames, on the inputs'
    device."""
    from voxtpu_torch.formants import estimate_formants_step

    F = res_freq.shape[0]
    file_len = _check_file_len(F, file_len)
    first = (torch.arange(F, device=res_freq.device) % file_len == 0)[:, None]
    prev_f = torch.where(first, est_freq, torch.cat([est_freq[None], out_f[:-1]]))
    prev_b = torch.where(first, est_bw, torch.cat([est_bw[None], out_b[:-1]]))
    new_f, new_b = estimate_formants_step(prev_f, prev_b, res_freq, res_bw)
    bad = (_bits(new_f) != _bits(out_f)).any(-1) | (_bits(new_b) != _bits(out_b)).any(-1)
    return bad.nonzero().flatten()
