"""`voxtpu_torch.dist.launch_multiprocess_dryrun` on the CPU: a real
`torch.distributed` cluster of `python -m voxtpu_torch._dist_worker` ranks
over gloo on this host, each rank's sharded outputs all-gathered and held
to the serial path (120 s timeout), and the launcher's refusals.
"""

import pytest
import torch

from voxtpu_torch import dist


def test_multiprocess_dryrun_two_gloo_ranks(monkeypatch, capsys):
    """A real two-process cluster on this host: each rank its two files over
    two listed CPUs, the outputs all-gathered over gloo and held to the
    serial path."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dist.launch_multiprocess_dryrun(n_devices=4, n_processes=2, timeout=120)
    out = capsys.readouterr().out
    assert out.count("multiprocess dryrun ok") == 2 and "backend=gloo" in out


def test_multiprocess_dryrun_needs_whole_ranks():
    with pytest.raises(ValueError, match="not divisible"):
        dist.launch_multiprocess_dryrun(n_devices=3, n_processes=2)


def test_multiprocess_dryrun_reports_a_failed_rank(monkeypatch):
    """Ranks asked to run on the card where there is none exit nonzero,
    and the launcher raises with their output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the ranks would run there")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="(?s)multiprocess dryrun failed.*NoCudaDevice"):
        dist.launch_multiprocess_dryrun(n_devices=1, n_processes=1, timeout=120, device="cuda", backend="gloo")


def test_multiprocess_dryrun_takes_one_device_a_rank():
    with pytest.raises(ValueError, match="1 devices named for 2 processes"):
        dist.launch_multiprocess_dryrun(n_devices=2, n_processes=2, device=["cpu"])
