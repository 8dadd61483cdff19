"""voxtpu_torch: the PyTorch + CUDA port of voxtpu for one NVIDIA H100.

Same modules and public names as `voxtpu`, in plain PyTorch around seven
hand-written CUDA kernels (`voxtpu_torch/csrc/*.cu`, built on first use by
`voxtpu_torch.ops.kernels`):

- the pitch pre-stage: normalise, lag window, maxima, parabolic frequency,
  band filter                               (`ops/pitch_pre.py`)
- Brent + windowed-sinc pitch refinement  (`ops/refine.py`)
- Burg LPC                                  (`ops/burg.py`)
- Laguerre + deflation polynomial roots     (`ops/find_roots.py`)
- the McCandless formant-slot scan          (`ops/formant_scan.py`)
- power spectrum + autocorrelation of power-of-two frames (`ops/ct_fused.py`)
- the Viterbi pitch-path DP                 (`ops/viterbi.py`)

Every kernel wrapper runs its plain PyTorch version for tensors on the CPU
and launches the kernel (or raises) for tensors on the card. The package
imports torch and never JAX or voxtpu.

Entry points (`voxtpu_torch.pipeline`): `analyze`, `analyze_batch`,
`analyze_batch_padded`, `analyze_long`, `StreamAnalyzer`. They run on the
card unless handed a tensor elsewhere or device="cpu"
(`voxtpu_torch.device`). The command line, `python -m voxtpu_torch
analyze|corpus|serve` (`voxtpu_torch.cli`; the HTTP daemon is
`voxtpu_torch.serve`), runs on the card unless given `--device cpu`.
`voxtpu_torch.dist` shards the analysis over a (files, frames) mesh of
devices and runs the multi-process dryrun; `voxtpu_torch.compat` holds
the reference-shaped shims and `voxtpu_torch.profiling` the timing
helpers.
"""

__all__ = ["pipeline"]
