"""Kernel F: the Viterbi pitch-path DP and its backtrace (csrc/viterbi.cu;
replaces voxtpu/ops/viterbi_pallas.py's `viterbi_path_pallas`).

`viterbi_path_plain` is the PyTorch version: the DP of
voxtpu.viterbi.pitch_path (viterbi.py:110-151) as a Python loop over frames,
batched over a leading recordings axis. `viterbi_path` runs it for CPU
tensors and, for CUDA tensors, launches the kernel's two device kernels:
every transition cost of the launch at once (`transition_costs_plain` is
their plain form), then one thread block per recording for the chain of
frame steps and the backtrace, in chunks of frame steps whose costs fit
in 16 MiB. Paths are bit-identical: both compute every cost in the same
op order (the frequency ratio before log2) and break ties to the first
winner. `launch_config` mirrors the kernel's launch rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voxtpu_torch.ops import kernels

__all__ = ["ViterbiConfig", "launch_config", "transition_costs_plain", "viterbi_path_plain", "viterbi_path"]

# Mirrors of csrc/viterbi.cu's constants.
_MAX_C = 128  # kMaxC
_CHAIN_THREADS = 128  # kChainThreads
_MAX_STAGES = 8  # kMaxStages
_SMEM_LIMIT = 232448  # kSmemLimit
_SCORES = _MAX_C + 32  # kScores, a score row's slots
_CHUNK = 16  # kChunk, items a lane loads before it compares
_SCRATCH_LIMIT = 16 << 20  # the records of one chunk of frame steps, all recordings ...
_MIN_STEPS = 64  # ... unless a chunk would hold fewer frame steps than this


class ViterbiConfig(NamedTuple):
    """A launch of kernel F (csrc/viterbi.cu config_for): lanes a candidate,
    the chain's threads (the block adds one producer warp), previous
    candidates a lane and their run's odd pitch, a record's bytes, records
    a ring stage, ring stages, dynamic shared memory a block, frame steps a
    chunk, and the scratch the records of a chunk take."""

    lanes: int
    chain: int
    run: int
    pitch: int
    record: int
    per: int
    stages: int
    smem: int
    steps: int
    scratch: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_config(B: int, F: int, C: int, dtype: torch.dtype) -> ViterbiConfig:
    """Kernel F's launch for B recordings of F frames of C candidates, a
    pure function of (B, F, C, dtype): G lanes a candidate (the largest
    power of two with G <= C and G C <= 128), each taking a run of L =
    ceil(C / G) previous candidates laid out at the pitch P = 1 + 16
    ceil((L - 1) / 16) (room for every 16-item chunk; odd, so a warp's 32
    lanes read 32 distinct banks), records of C rows of G runs and
    the C local scores rounded to 16 bytes, two records a ring stage where
    two stages of two fit, and as many stages (at most 8) as fit in 227 KB
    beside two score rows, the mbarriers and the path's start; chunks of
    as many frame steps as fit in 16 MiB for all B recordings, at least 64
    and at most F - 1 (0 at F = 1), so the scratch, B steps records, is at
    most the larger of 16 MiB and 64 records a recording, whatever F."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"viterbi_path: kernels take float32 or float64, got {dtype}")
    if not 1 <= C <= _MAX_C or F < 1 or B < 0:
        raise ValueError(f"viterbi_path: B >= 0, F >= 1 and 1 <= C <= {_MAX_C}; got {B}, {F}, {C}")
    isz = dtype.itemsize
    lanes = 32
    while lanes > C or lanes * C > _CHAIN_THREADS:
        lanes //= 2
    run = -(-C // lanes)
    pitch = _round_up(run - 1, _CHUNK) + 1
    record = _round_up((C * lanes * pitch + C) * isz, 16)
    fixed = _round_up(2 * _SCORES * isz, 16) + 2 * _MAX_STAGES * 8 + 16
    fit = (_SMEM_LIMIT - fixed) // record
    per = 2 if fit >= 4 else 1
    stages = min(_MAX_STAGES, fit // per)
    steps = min(F - 1, max(_MIN_STEPS, _SCRATCH_LIMIT // max(B * record, 1)))
    return ViterbiConfig(lanes, _round_up(lanes * C, 32), run, pitch, record, per, stages,
                         stages * per * record + fixed, steps, B * steps * record)


def _chunks(F: int, steps: int) -> int:
    """The chunks csrc/viterbi.cu's host loop runs for F frames in chunks of
    `steps` frame steps: one pre-pass and one chain each; at F = 1 one chain
    and no pre-pass."""
    return 1 if F == 1 else -(-(F - 1) // steps)


def _batched(local, freq, voiced):
    if local.dim() == 2:
        return local[None], freq[None], voiced[None], True
    return local, freq, voiced, False


def _step_costs(freq, voiced, t, ojc: float, vuc_t, zero):
    """cost(t, i, j) for every previous candidate i and current j, (B, C, C)."""
    vp, vc = voiced[:, t - 1, :, None], voiced[:, t, None, :]
    jump = torch.abs(torch.log2(freq[:, t - 1, :, None] / freq[:, t, None, :]))
    return torch.where(vp & vc, ojc * jump, torch.where(vp ^ vc, vuc_t, zero))


def transition_costs_plain(freq: torch.Tensor, voiced: torch.Tensor, ojc: float, vuc: float) -> torch.Tensor:
    """Every transition cost of (B, F, C) candidates, (B, F - 1, C, C):
    [b, t - 1, i, j] is the cost from candidate i of frame t - 1 to j of
    frame t, as `viterbi_path_plain` forms it at step t; the plain form of
    the kernel's pre-pass, which stores it transposed, a row a j."""
    B, F, C = freq.shape
    vuc_t = torch.tensor(vuc, dtype=freq.dtype, device=freq.device)
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    out = torch.empty((B, max(F - 1, 0), C, C), dtype=freq.dtype, device=freq.device)
    for t in range(1, F):
        out[:, t - 1] = _step_costs(freq, voiced, t, ojc, vuc_t, zero)
    return out


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
        cost = _step_costs(freq, voiced, t, ojc, vuc_t, zero)
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


def _launch(local, freq, voiced, ojc: float, vuc: float, steps: int | None = None,
            stamps: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F on (B, F, C) CUDA tensors, in chunks of `steps` frame steps
    (`launch_config`'s by default); stamps: None, or an int64 tensor of 8
    that thread 0 of recording 0's chain adds its probe's clocks to (the
    frame loop's clocks, those spent waiting for a record, the steps, the
    loop's nanoseconds, and the clocks in the lanes' argmax, in the combine
    and shuffles, in the stores, and at the barrier and the release), run
    by a second instantiation of the chain. Returns the (B, F) path."""
    if kernels.on_cpu(local, freq, voiced):
        raise ValueError("viterbi_path: kernel F runs on the card only")
    B, F, C = local.shape
    config = launch_config(B, F, C, local.dtype)
    steps = config.steps if steps is None else steps
    if F > 1 and not 1 <= steps <= F - 1:
        raise ValueError(f"viterbi_path: 1 <= steps <= F - 1 = {F - 1}; got {steps}")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.numel() != 8 or stamps.device != local.device):
        raise ValueError("viterbi_path: stamps is an int64 tensor of 8 on the inputs' device")
    args = [t.contiguous() for t in (local, freq, voiced)]
    records = torch.empty((B * steps * config.record,), dtype=torch.uint8, device=local.device)
    carry = torch.empty((B, C), dtype=local.dtype, device=local.device)
    bp = torch.empty((B, F, C), dtype=torch.int32, device=local.device)
    path = torch.empty((B, F), dtype=torch.int32, device=local.device)
    kernels.launch("vt_viterbi", local.dtype, *args, records, carry, bp, path, stamps, B, F, C, config.record,
                   steps, float(ojc), float(vuc))
    return path


def viterbi_path(
    local: torch.Tensor, freq: torch.Tensor, voiced: torch.Tensor, ojc: float, vuc: float,
) -> torch.Tensor:
    """`viterbi_path_plain` for CPU tensors; on the card, csrc/viterbi.cu:
    one call for all B recordings, C <= 128, its records in scratch of
    `launch_config(B, F, C, dtype).scratch` bytes."""
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
    path = _launch(local, freq, voiced, ojc, vuc)
    viterbi_path.launches += 1
    viterbi_path.chunks += _chunks(F, launch_config(B, F, C, local.dtype).steps)
    return path[0] if squeeze else path


viterbi_path.launches = 0
viterbi_path.chunks = 0  # the chunks its launches ran (see _chunks)
