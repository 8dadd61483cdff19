"""Formant extraction example on voxtpu_torch, the twin of
examples/formant_extraction.py: resample the bundled two-vowels recording
toward 10 kHz analysis, 50 ms frames / 10 ms hops, order-13 Burg LPC,
tracked formants + RMS + pitch printed as gnuplot columns (see
scripts/plot_formants.gnuplot).

Run: python examples/torch/formant_extraction.py [--device cuda|cpu] > output.txt
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from voxtpu_torch.cli import main as cli_main  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    wav = os.path.join(ROOT, "tests", "fixtures", "sample-two_vowels.wav")
    return cli_main([
        "analyze", wav,
        "--resample-hz", "10000",
        "--frame-ms", "50", "--hop-ms", "10",
        "--n-coeffs", "13",
        "--fmin", "50", "--fmax", "200",
        "--device", args.device,
    ])


if __name__ == "__main__":
    raise SystemExit(main())
