"""voxtpu_torch: the PyTorch + CUDA port of voxtpu for one NVIDIA H100.

Same modules and public names as `voxtpu`, in plain PyTorch around nine
hand-written CUDA kernels (`voxtpu_torch/csrc/*.cu`, built on first use by
`voxtpu_torch.ops.kernels`):

- the pitch pre-stage: normalise, lag window, maxima, parabolic frequency,
  band filter                               (`ops/pitch_pre.py`, G)
- Brent + windowed-sinc pitch refinement  (`ops/refine.py`, A)
- Burg LPC                                  (`ops/burg.py`, B)
- Laguerre + deflation polynomial roots     (`ops/find_roots.py`, C)
- the McCandless formant-slot scan          (`ops/formant_scan.py`, D)
- power spectrum + autocorrelation of power-of-two frames (`ops/ct_fused.py`, E)
- the same by the four-step decomposition on the tensor cores, three
  bfloat16 passes (`ops/ct_x3.py`, X3; backend "ct_fused_x3", opt-in)
- the Viterbi pitch-path DP                 (`ops/viterbi.py`, F)
- the float32 root polish                   (`ops/polish.py`, P)

Every kernel wrapper runs its plain PyTorch version for tensors on the CPU
and launches the kernel (or raises) for tensors on the card. The package
imports torch and never JAX or voxtpu.

Entry points (`voxtpu_torch.pipeline`): `analyze`, `analyze_batch`,
`analyze_batch_padded`, `analyze_long`, `StreamAnalyzer`. They run on the
card unless handed a tensor elsewhere or device="cpu"
(`voxtpu_torch.device`). The command line, `python -m voxtpu_torch
analyze|corpus|serve|bench` (`voxtpu_torch.cli`; the HTTP daemon is
`voxtpu_torch.serve`, the benchmark `voxtpu_torch.bench`), runs on the card
unless given `--device cpu`. `voxtpu_torch.dist` shards the analysis over a
(files, frames) mesh of devices and runs the multi-process dryrun;
`voxtpu_torch.compat` holds the reference-shaped shims and
`voxtpu_torch.profiling` the timing helpers.
"""

from voxtpu_torch import errors, pipeline
from voxtpu_torch.waves import rms, amplitude, max_amplitude, normalize, preemphasis
from voxtpu_torch.windows import hann, hanning_lag
from voxtpu_torch.autocorr import autocorrelate
from voxtpu_torch.lpc import levinson, burg
from voxtpu_torch.cplx import C, csqrt
from voxtpu_torch.roots import degree, off_low, laguerre, find_roots, polish_roots
from voxtpu_torch.resonance import resonances_from_roots, sort_and_pack_resonances
from voxtpu_torch.formants import (
    MAX_RESONANCES,
    MALE_FORMANT_ESTIMATES,
    FEMALE_FORMANT_ESTIMATES,
    estimate_formants_step,
    formant_tracker,
    find_formants,
    resample_linear,
)
from voxtpu_torch.sinc import interpolate_sinc, brent_maximize_sinc, improve_extremum_sinc
from voxtpu_torch.pitch import pitch_frames, best_pitch
from voxtpu_torch.viterbi import PathConfig, pitch_path, pitch_track
# `mfcc` the function stays `voxtpu_torch.mfcc.mfcc`: re-exported here it
# would shadow the module of that name (`from voxtpu_torch import mfcc`).
from voxtpu_torch.mfcc import hz_to_mel, mel_to_hz, dct
from voxtpu_torch.frame import frame_signal, num_frames
from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.pipeline import (
    AnalysisConfig,
    PitchConfig,
    FormantConfig,
    MfccConfig,
    analyze,
    analyze_batch,
    analyze_frames,
    analyze_long,
    analyze_stream,
    finalize_viterbi,
    StreamAnalyzer,
)

__version__ = "0.1.0"

__all__ = [
    "errors",
    "pipeline",
    # waves
    "rms",
    "amplitude",
    "max_amplitude",
    "normalize",
    "preemphasis",
    # windows
    "hann",
    "hanning_lag",
    # periodic
    "autocorrelate",
    "interpolate_sinc",
    "brent_maximize_sinc",
    "improve_extremum_sinc",
    "pitch_frames",
    "best_pitch",
    # viterbi
    "PathConfig",
    "pitch_path",
    "pitch_track",
    # spectrum
    "levinson",
    "burg",
    "resonances_from_roots",
    "sort_and_pack_resonances",
    "estimate_formants_step",
    "formant_tracker",
    "hz_to_mel",
    "mel_to_hz",
    "dct",
    # polynomial / complex
    "C",
    "csqrt",
    "degree",
    "off_low",
    "laguerre",
    "find_roots",
    "polish_roots",
    # the pipeline of lib.rs
    "MAX_RESONANCES",
    "MALE_FORMANT_ESTIMATES",
    "FEMALE_FORMANT_ESTIMATES",
    "find_formants",
    "resample_linear",
    # drivers
    "frame_signal",
    "num_frames",
    "read_wav",
    "AnalysisConfig",
    "PitchConfig",
    "FormantConfig",
    "MfccConfig",
    "analyze",
    "analyze_batch",
    "analyze_frames",
    "analyze_long",
    "analyze_stream",
    "StreamAnalyzer",
    "finalize_viterbi",
]
