"""Pitch detection example on voxtpu_torch, the twin of
examples/pitch_detection.py: a 150 Hz sine at 44.1 kHz, Hann frames of
2048 with hop 1024, Boersma candidates per frame, the whole signal in one
batched call.

Run: python examples/torch/pitch_detection.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from voxtpu_torch.device import resolve_device  # noqa: E402
from voxtpu_torch.frame import frame_signal  # noqa: E402
from voxtpu_torch.pitch import pitch_frames  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    exp_freq = 150.0
    sr = 44100.0
    n, hop = 2048, 1024
    t = np.arange(int(n + 1)) / sr
    signal = torch.as_tensor(np.sin(2 * np.pi * exp_freq * t), device=resolve_device(args.device))

    frames = frame_signal(signal, n, hop, window="hanning")
    freq, strength, valid = pitch_frames(frames, sr, threshold=0.2, fmin=100.0, fmax=500.0)
    freq, strength, valid = freq.cpu().numpy(), strength.cpu().numpy(), valid.cpu().numpy()
    for i in range(frames.shape[0]):
        f = freq[i][valid[i]]
        s = strength[i][valid[i]]
        print(f"frame {i}: best f0 = {f[0]:.4f} Hz (strength {s[0]:.4f}), {len(f)} candidates")


if __name__ == "__main__":
    main()
