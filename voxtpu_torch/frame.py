"""Signal framing: the batching axis of the whole pipeline.

Port of voxtpu.frame. Frames are full windows at offsets 0, hop, 2*hop, ...
(partial tails dropped), with optional rectangular or Hann weighting. On a
GPU a strided view is free, so framing is `unfold` + `contiguous()`; the
gcd-row slice form of voxtpu.frame was a TPU gather workaround.
"""

from __future__ import annotations

import torch

from voxtpu_torch.windows import hann

__all__ = ["num_frames", "frame_signal"]


def num_frames(n: int, frame_len: int, hop: int) -> int:
    if n < frame_len:
        return 0
    return (n - frame_len) // hop + 1


def frame_signal(x, frame_len: int, hop: int, window: str = "rectangle") -> torch.Tensor:
    """Extract (..., F, frame_len) frames from (..., n) signals.

    window: "rectangle" (no weighting) or "hanning" (periodic Hann, phase
    i/frame_len). The result is a fresh contiguous tensor on x's device.
    """
    x = torch.as_tensor(x)
    n = x.shape[-1]
    f = num_frames(n, frame_len, hop)
    if f <= 0:
        raise ValueError(f"signal too short: {n} samples < frame {frame_len}")
    frames = x[..., : (f - 1) * hop + frame_len].unfold(-1, frame_len, hop).contiguous()
    if window == "hanning":
        frames = frames * torch.as_tensor(hann(frame_len), dtype=frames.dtype, device=frames.device)
    elif window != "rectangle":
        raise ValueError(f"unknown window: {window}")
    return frames
