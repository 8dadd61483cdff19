"""Corpus-scale sharding over a ("files", "frames") grid of devices.

Port of voxtpu.dist. A `Mesh` is a 2-D grid of torch devices:

- the **files** axis is data parallelism over recordings;
- the **frames** axis shards one recording's frames, the analogue of
  sequence parallelism for long audio.

Every stage is frame-parallel except the McCandless formant carry (kernel
D) and the optional Viterbi pitch path (kernel F). Those read small
per-frame summaries (32 resonances, 33 pitch candidates), so the costly
stages (pitch candidates, Burg LPC, roots, MFCC) always run on the grid
blocks, and the carry runs one of two ways:

- **exact (default):** each files row's resonances are gathered over the
  whole frame axis onto the row's first device, trimmed to the real frame
  count, and kernel D runs once for the row, one carry a file: the serial
  path's values, bit for bit where the blocks' resonances are;
- **halo (exact=False):** each block takes its left neighbour's last
  `overlap` frames of resonances (a device-to-device copy, voxtpu's
  `ppermute`), runs D over [halo | own] and drops the halo outputs. The
  first block's halo is zeros, which the tracker passes over exactly.

The Viterbi path always runs exactly, per files row over the gathered
candidates, with each recording's intensity peak over its trimmed frames.
Outputs land on the mesh's first device.

A block's launches go to its own device's current stream and nothing waits
on the host between blocks, so distinct cards overlap. PyTorch has no
virtual devices: a caller may list one device several times (the CPU in
the tests, one card in `chip_smoke.py`), and its blocks then run in turn.
No default repeats a device.

`init_distributed`, `launch_multiprocess_dryrun` and
`voxtpu_torch._dist_worker` run a real multi-process cluster over
`torch.distributed`: the files axis across processes (hosts), the frames
axis over each process's devices.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from voxtpu_torch.device import constant, resolve_device
from voxtpu_torch.formants import formant_tracker_batched
from voxtpu_torch.pipeline import (
    AnalysisConfig, FormantConfig, MfccConfig, PitchConfig, _local_peak, _path_outputs, _without_viterbi,
    analyze_frames,
)

__all__ = [
    "Mesh", "local_devices", "make_mesh", "init_distributed", "sharded_analyze", "dryrun_case",
    "default_topologies", "dryrun_multichip", "launch_multiprocess_dryrun",
]

# The keys every dryrun holds against the serial path (voxtpu/dist.py:417-418).
DRYRUN_KEYS = ("f0", "f0_strength", "formant_freqs", "formant_bws", "mfcc", "rms", "status")


class Mesh:
    """A (files, frames) grid of torch devices; `shape` is voxtpu's dict."""

    def __init__(self, grid):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or not self.grid[0] or any(len(r) != len(self.grid[0]) for r in self.grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"files": len(self.grid), "frames": len(self.grid[0])}

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.grid]})"


def local_devices(device=None) -> list:
    """This process's distinct devices of `device`'s kind: every CUDA card
    (`cuda:0` .. `cuda:n-1`), or the one CPU. None means the card
    (`device.resolve_device`: without one it raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh(n_files_axis: int, n_frames_axis: int, devices=None) -> Mesh:
    """The first n_files_axis * n_frames_axis of `devices` (default
    `local_devices()`) as a (files, frames) grid, row-major."""
    devices = list(devices) if devices is not None else local_devices()
    need = n_files_axis * n_frames_axis
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[i * n_frames_axis : (i + 1) * n_frames_axis] for i in range(n_files_axis)])


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, backend: str | None = None,
                     device=None) -> str:
    """Join a `torch.distributed` cluster at `coordinator_address`
    ("host:port", or a "tcp://" URL) as rank `process_id` of
    `num_processes`; returns the backend. The backend is the caller's, or
    "nccl" when `device` (default: the card) is a CUDA device and "gloo"
    on the CPU. NCCL takes one rank a card: ranks that share a card name
    "gloo". A failed join raises."""
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return backend


def sharded_analyze(frames, config: AnalysisConfig, mesh: Mesh, overlap: int = 8, exact: bool = True) -> dict:
    """Analyze (files, F, n) frames (or one recording's (F, n)) over the
    mesh: files on the "files" axis, frames on the "frames" axis.

    The formant carry follows `exact` (module docstring); the Viterbi path
    (when the config asks for it) always runs exactly over the gathered
    candidates. `overlap` matters only with exact=False, and is at most a
    block's frame count. A tensor input stays where it is until each block
    is copied to its device; NumPy input goes to the mesh's first device.
    Returns (files, F, ...) tensors on the mesh's first device."""
    first = mesh.grid[0][0]
    x = frames if isinstance(frames, torch.Tensor) else torch.as_tensor(np.asarray(frames), device=first)
    if x.dim() == 2:
        x = x[None]
    files, F_orig, n = x.shape
    nrows, nshards = mesh.shape["files"], mesh.shape["frames"]
    if files % nrows:
        raise ValueError(f"{files} files do not split over a files axis of {nrows}")
    # Zero frames pad F to a multiple of the frames axis: the tracker passes
    # over them exactly, and every output is trimmed to F_orig before a
    # sequential stage sees it.
    F = -(-F_orig // nshards) * nshards
    if F != F_orig:
        x = torch.nn.functional.pad(x, (0, 0, 0, F - F_orig))
    overlap = min(overlap, F // nshards)
    fl, Fl = files // nrows, F // nshards

    do_formants = config.formant.enabled
    do_viterbi = config.pitch.enabled and config.pitch.viterbi
    inner = _without_viterbi(config) if do_viterbi else config
    halo = do_formants and not exact and nshards > 1 and overlap > 0

    # The blocks, frame-parallel: files and frames flatten into one batch.
    blocks = []
    for i, row in enumerate(mesh.grid):
        blocks.append([])
        for j, dev in enumerate(row):
            local = x[i * fl : (i + 1) * fl, j * Fl : (j + 1) * Fl].to(dev, non_blocking=True)
            out = analyze_frames(local.reshape(-1, n), inner, return_formant_candidates=do_formants)
            out = {k: v.reshape((fl, Fl) + v.shape[1:]) for k, v in out.items()}
            if do_viterbi:
                out["local_peak"] = _local_peak(local)
            blocks[-1].append(out)

    if do_formants and not exact:
        for row, devs in zip(blocks, mesh.grid):
            # Each block's halo: its left neighbour's last resonances, taken
            # before this loop pops them.
            tails = [(b["resonance_freqs"][:, -overlap:], b["resonance_bws"][:, -overlap:]) for b in row]
            for j, (out, dev) in enumerate(zip(row, devs)):
                rf, rb = out.pop("resonance_freqs"), out.pop("resonance_bws")
                if halo:
                    hf, hb = tails[j - 1] if j else (torch.zeros_like(rf[:, :overlap]),) * 2
                    rf = torch.cat([hf.to(dev, non_blocking=True), rf], dim=1)
                    rb = torch.cat([hb.to(dev, non_blocking=True), rb], dim=1)
                ef, eb = _seed(config.formant, rf.dtype, dev)
                freqs, bws = formant_tracker_batched(rf, rb, ef, eb)
                skip = overlap if halo else 0
                out["formant_freqs"], out["formant_bws"] = freqs[:, skip:], bws[:, skip:]

    rows = []
    for row, devs in zip(blocks, mesh.grid):
        home = devs[0]
        out = {k: torch.cat([b[k].to(home, non_blocking=True) for b in row], dim=1)[:, :F_orig] for k in row[0]}
        if do_formants and exact:
            # The exact carry over the row's whole (trimmed) frame axis.
            ef, eb = _seed(config.formant, out["resonance_freqs"].dtype, home)
            out["formant_freqs"], out["formant_bws"] = formant_tracker_batched(
                out.pop("resonance_freqs"), out.pop("resonance_bws"), ef, eb)
        if do_viterbi:
            out.update(_path_outputs(out, config, out.pop("local_peak")))
        rows.append(out)
    return {k: torch.cat([r[k].to(first, non_blocking=True) for r in rows]) for k in rows[0]}


def _seed(f: FormantConfig, dtype: torch.dtype, device: torch.device) -> tuple:
    est_f = constant(np.asarray, f.estimates, dtype=dtype, device=device)
    return est_f, torch.full_like(est_f, f.estimate_bandwidth)


def dryrun_case(files: int, F: int, frame_len: int = 128, hop: int = 64, sr: float = 8000.0):
    """voxtpu's dryrun fixture (voxtpu/dist.py:223-243), the same values from
    `default_rng(0)`: (files, F, frame_len) float32 frames of a 220 Hz sine
    plus noise, and its configuration (Viterbi on, order 8, 8 MFCCs).
    Every dryrun, in one process or several, analyzes the same data."""
    rng = np.random.default_rng(0)
    t = np.arange(frame_len) / sr
    base = np.sin(2 * np.pi * 220.0 * t)
    frames = (base[None, None, :] + 0.1 * rng.standard_normal((files, F, frame_len))).astype(np.float32)
    config = AnalysisConfig(
        sample_rate=sr,
        frame_len=frame_len,
        hop=hop,
        pitch=PitchConfig(fmin=150.0, fmax=400.0, max_candidates=8, viterbi=True),
        formant=FormantConfig(n_coeffs=8),
        mfcc=MfccConfig(num_coeffs=8, freq_hi=3500.0),
    )
    return frames, config


def default_topologies(n_devices: int) -> list[tuple[int, int]]:
    """(files, frames) shapes of the dryrun: every factorization of
    n_devices, plus a 1x2 sub-mesh (fewer devices than there are)."""
    topos = [(f, n_devices // f) for f in range(1, n_devices + 1) if n_devices % f == 0]
    if n_devices > 2:
        topos.append((1, 2))
    return topos


def _serial_reference(frames: np.ndarray, config: AnalysisConfig, device: torch.device) -> dict:
    """Per-file serial `analyze_frames` on `device`, as host arrays: what
    every topology's exact mode must reproduce."""
    out: dict = {}
    for i in range(frames.shape[0]):
        for k, v in analyze_frames(torch.as_tensor(frames[i], device=device), config).items():
            out.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def _check_keys(got: dict, want: dict, where: str) -> int:
    """DRYRUN_KEYS of got against want at voxtpu's dryrun tolerance."""
    for k in DRYRUN_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"{k} @ {where}")
    return len(DRYRUN_KEYS)


def dryrun_multichip(n_devices: int, topologies=None, devices=None) -> None:
    """Sharded analysis over a matrix of (files, frames) mesh shapes on
    `devices` (default `local_devices()`; list one device k times to hold
    every shape on it), voxtpu's `dryrun_multichip`.

    For each topology the whole pipeline (pitch, Viterbi, formants with the
    exact carry, MFCC, RMS) runs on voxtpu's fixture with more than one file
    a files row and one real file more than a multiple of the files axis
    (the rest zero files, as the corpus loop pads), and a frame count that
    the frames axis does not divide (the pad path); exact mode must equal
    the per-file serial path. Then the halo mode runs on the widest mesh.
    voxtpu's single-process `init_distributed` call has no counterpart: a
    process group is process-wide state, and `launch_multiprocess_dryrun`
    runs a real cluster."""
    devices = list(devices) if devices is not None else local_devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}; pass devices=[device] * {n_devices} "
                           "to hold the topologies on one device")
    if topologies is None:
        topologies = default_topologies(n_devices)
    for files_axis, frames_axis in topologies:
        mesh = make_mesh(files_axis, frames_axis, devices)
        F = frames_axis * 4 + (3 if frames_axis > 1 else 0)
        real_files = files_axis + 1 if files_axis > 1 else 2
        files = -(-real_files // files_axis) * files_axis
        frames, config = dryrun_case(real_files, F)
        padded = np.concatenate([frames, np.zeros((files - real_files,) + frames.shape[1:], frames.dtype)])
        out = {k: v.cpu().numpy() for k, v in sharded_analyze(padded, config, mesh, exact=True).items()}
        assert out["f0"].shape == (files, F), out["f0"].shape
        serial = _serial_reference(frames, config, mesh.grid[0][0])
        checked = _check_keys({k: v[:real_files] for k, v in out.items()}, serial,
                              f"mesh {files_axis}x{frames_axis}")
        print(f"dryrun topology ok: mesh={{'files': {files_axis}, 'frames': {frames_axis}}} "
              f"files={real_files}(+{files - real_files} pad) F={F} features_checked={checked}")

    files_axis, frames_axis = max(topologies, key=lambda t: t[1])
    mesh = make_mesh(files_axis, frames_axis, devices)
    frames, config = dryrun_case(files_axis, frames_axis * 4 + 1)
    out2 = sharded_analyze(frames, config, mesh, overlap=2, exact=False)
    assert tuple(out2["f0"].shape) == frames.shape[:2], out2["f0"].shape
    print(f"dryrun_multichip ok: {len(topologies)} topologies on {n_devices} devices "
          f"({', '.join(sorted({str(d) for d in devices[:n_devices]}))}) + halo mode on {files_axis}x{frames_axis}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_multiprocess_dryrun(n_devices: int = 8, n_processes: int = 2, timeout: float = 900.0,
                               device="cpu", backend: str | None = None) -> None:
    """Run a real multi-process `torch.distributed` cluster on this host.

    Spawns `n_processes` ranks of `python -m voxtpu_torch._dist_worker` on a
    free localhost port. Each rank lists its device n_devices // n_processes
    times as its local devices (the stand-in for a host's cards): `device`
    is every rank's, or a list of one device a rank. A rank takes its rows
    of the files axis (process-major), runs `sharded_analyze` over its local
    (1, local devices) mesh, all-gathers the outputs and holds the whole
    gathered result to the serial path. `backend` is passed on (None:
    `init_distributed`'s choice for the device); ranks that share a card
    need "gloo". Raises on a rank's nonzero exit, a missing ok line or the
    cluster outliving `timeout` seconds (its ranks are killed)."""
    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices not divisible by {n_processes} processes")
    devices = [device] * n_processes if isinstance(device, str) else list(device)
    if len(devices) != n_processes:
        raise ValueError(f"{len(devices)} devices named for {n_processes} processes")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coordinator = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "voxtpu_torch._dist_worker", "--num-processes", str(n_processes),
           "--coordinator", coordinator, "--local-devices", str(n_devices // n_processes)]
    if backend is not None:
        cmd += ["--backend", backend]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i), "--device", str(devices[i])], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n_processes)]
    deadline = time.monotonic() + timeout
    outputs, rcs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[launcher] TIMEOUT"
        outputs.append(out)
        rcs.append(p.returncode)
    for out in outputs:
        sys.stdout.write(out)
    sys.stdout.flush()
    ok_lines = sum("multiprocess dryrun ok" in out for out in outputs)
    if any(rc != 0 for rc in rcs) or ok_lines != n_processes:
        raise RuntimeError(f"multiprocess dryrun failed: rcs={rcs}, ok_lines={ok_lines}/{n_processes}\n"
                           + "\n".join(o[-2000:] for o in outputs))
