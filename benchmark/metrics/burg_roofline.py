"""Kernel B's share of its roofline (layer: kernels), in %: the least time
Burg's recursion needs at the traced blocks' real frames (the frame length,
the LPC order, float32; `harness.bounds.burg_bound`) over B's device time.
Padding frames are not counted, so they show as waste."""

from benchmark.harness.bounds import burg_bound
from benchmark.harness.trace import kernel_of

KERNELS = frozenset(["burg_kernel", "burg_cluster_kernel"])


def read(trace):
    secs = trace.seconds_of(lambda n: kernel_of(n, KERNELS) is not None)
    if secs <= 0:
        return None
    cfg = trace.config
    least, _ = burg_bound(trace.real_frames(), cfg["frame_len"], cfg["formant"]["n_coeffs"])
    return 100.0 * least / secs
