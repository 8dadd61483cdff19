"""Where the entry points run: on the card unless the caller says otherwise.

`as_input` is the one rule every entry point (`pipeline.analyze*`,
`StreamAnalyzer`, `viterbi.pitch_track`) applies to its input:
- a `torch.Tensor` keeps its device (a CPU tensor is the caller's choice),
  or moves to `device` when one is given;
- anything else (NumPy arrays, lists) goes to `device`, which defaults to
  the CUDA card. Without one that raises: nothing falls back to the CPU.
  `device="cpu"` runs on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["NoCudaDevice", "resolve_device", "as_input", "constant", "pin_fp32_matmul"]


class NoCudaDevice(RuntimeError):
    """An entry point was asked to run on the card and there is none."""


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on: `device`, or the card when
    None. A CUDA device without a card raises `NoCudaDevice`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device: voxtpu_torch runs on the card by default; pass device='cpu' "
            "(or a CPU tensor) to run on the CPU"
        )
    return dev


def as_input(x, device=None) -> torch.Tensor:
    """`x` as a tensor on the device it runs on (see the module docstring)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def pin_fp32_matmul() -> None:
    """Float32 products in full float32, never TF32, for cuBLAS and cuDNN:
    TF32 keeps about three decimal digits. Every module with float32
    matmuls calls it before its products (mfcc, the "ct" backend)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=256)
def constant(make, *args, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`make(*args)` (a window, a matrix: NumPy) as a `dtype` tensor on
    `device`, made and copied once for each (make, args, dtype, device) and
    then shared, so callers must not write to it. A copy from host memory to
    the card waits for the device to finish its queued work; cached, the
    pipeline's constants cost that wait on the first call alone, and a
    warm call queues its work without waiting."""
    return torch.as_tensor(np.asarray(make(*args)), dtype=dtype, device=device)
