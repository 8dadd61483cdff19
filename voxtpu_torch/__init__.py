"""voxtpu_torch: the PyTorch + CUDA port of voxtpu for one NVIDIA H100.

Same modules and public names as `voxtpu`, in plain PyTorch around four
hand-written CUDA kernels (`voxtpu_torch/csrc/*.cu`, built on first use by
`voxtpu_torch.ops.kernels`):

- Brent + windowed-sinc pitch refinement  (`ops/refine.py`)
- Burg LPC                                  (`ops/burg.py`)
- Laguerre + deflation polynomial roots     (`ops/find_roots.py`)
- the McCandless formant-slot scan          (`ops/formant_scan.py`)

Every kernel wrapper runs its plain PyTorch version for tensors on the CPU
and launches the kernel (or raises) for tensors on the card. The package
imports torch and never JAX or voxtpu.

Entry point: `voxtpu_torch.pipeline.analyze(samples, config)`.
"""

__all__ = ["pipeline"]
