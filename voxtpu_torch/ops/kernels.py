"""Build, load and launch the port's CUDA kernels.

Every `voxtpu_torch/csrc/*.cu` compiles with nvcc, for sm_90a, into ONE
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ctypes: one nvcc process a source, all started
together, then one link. The library lands in
`build/voxtpu_torch/` at the root of the checkout, named by a hash of the
sources and flags, so an edited source never loads a stale build. Nothing
is built when this module is imported: the first kernel launch builds.

There is no fallback. Without nvcc, or when the build fails, `library()`
raises `KernelBuildError`; a launch that CUDA refuses raises
`KernelLaunchError`. The wrappers in `voxtpu_torch.ops` run their plain
PyTorch versions only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "KernelBuildError", "KernelLaunchError", "find_nvcc", "library_path", "build",
    "library", "on_cpu", "launch", "suffixes",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "voxtpu_torch"
# --fmad=false: no contraction of a * b + c into one fused multiply-add, so
# the kernels round like the plain versions (and like the reference). Brent
# over the windowed sinc is chaotic where its start or result sits on the
# integer-snap edge; contraction alone sent 56 of 371,553 float64 candidates
# of the 44.1 kHz slice to another local maximum (measured on an H100).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Argument kinds of each exported launcher, before the trailing stream
# pointer: p = device pointer, i = int, d = double.
_SIGNATURES = {
    "vt_refine": "ppppppiiiiiiid",
    "vt_burg": "ppppiiiiiii",
    "vt_roots": "ppppppii",
    "vt_formant_scan": "ppppppppiiii",
    "vt_ct_fused": "pppppiii",
    "vt_viterbi": "ppppppppiiiiidd",
    "vt_pitch_pre": "pppppiiiddd",
    "vt_polish": "ppppppiiid",
    "vt_ct_x3": "pppppii",
}
# The launchers built for float32 only (the rest take both dtypes).
_FLOAT32_ONLY = frozenset(["vt_ct_x3"])
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# Held around the first build and load. `functools.cache` does not stop two
# threads (a server's dispatcher and its stream handlers) from running
# `library()`'s body at once, and `build()` names its objects by process,
# so two threads of one process would write the same object files.
_LIBRARY_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """CUDA refused a kernel launch."""


def find_nvcc() -> str | None:
    """The CUDA compiler: $CUDA_HOME/bin, $CUDA_PATH/bin, /usr/local/cuda/bin,
    then PATH. None when there is none."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvoxtpu_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or KernelBuildError
    naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise KernelBuildError(f"nvcc failed (exit {p.returncode}):\n{' '.join(cmd)}\n{text}")
    return "".join(outputs)


def build() -> Path:
    """Compile every kernel into the shared library; returns its path.

    Each source compiles in its own nvcc process, all at once, to an object
    file next to the library; one more nvcc links them. The compiler's
    report (`-Xptxas -v`: registers, shared memory and spills per kernel)
    is written beside the library as `<name>.log`.
    """
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda and PATH): "
            "the voxtpu_torch CUDA kernels cannot be built"
        )
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in _sources()]
    tmp = out.with_name(f"{tag}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, _sources())])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, kinds in _SIGNATURES.items():
        for suffix in suffixes(name):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def suffixes(symbol: str) -> tuple[str, ...]:
    """The dtype suffixes `symbol` is exported with."""
    return ("f32",) if symbol in _FLOAT32_ONLY else tuple(_SUFFIX.values())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none.
    Thread-safe: the first caller builds and loads, the others wait for it
    and get the same handle."""
    with _LIBRARY_LOCK:
        return _load()


library.cache_clear = _load.cache_clear  # forget the handle (tests)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every tensor lies
    on one CUDA device. Anything else raises: a kernel takes CUDA tensors
    only, and the plain versions run only for CPU tensors."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA device, got {devices}")


def launch(symbol: str, dtype: torch.dtype, *args) -> None:
    """Launch `symbol` for `dtype` on the current stream of the device of
    the first tensor argument. Tensors must be contiguous; their data
    pointers are passed, other arguments as they are."""
    if dtype not in _SUFFIX or _SUFFIX[dtype] not in suffixes(symbol):
        raise TypeError(f"{symbol}: no kernel for {dtype} (it takes {', '.join(suffixes(symbol))})")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: tensor arguments must be contiguous")
    device = tensors[0].device
    lib = library()
    fn = getattr(lib, f"{symbol}_{_SUFFIX[dtype]}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"{symbol}: CUDA error {err} ({lib.vt_error_string(err).decode()})")
