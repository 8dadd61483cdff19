"""Kernel F's share of its roofline (layer: kernels), in %: the least time
the path search's dynamic programme needs at the traced blocks' real frames
and the candidates a frame (`harness.bounds.viterbi_bound`), over the
device time of F's two kernels. Padding frames are not counted."""

from benchmark.harness.bounds import viterbi_bound
from benchmark.harness.trace import kernel_of

KERNELS = frozenset(["viterbi_costs", "viterbi_chain"])


def read(trace):
    secs = trace.seconds_of(lambda n: kernel_of(n, KERNELS) is not None)
    if secs <= 0 or not trace.config["pitch"]["viterbi"]:
        return None
    least, _ = viterbi_bound(trace.real_frames(), trace.config["pitch"]["max_candidates"] + 1)
    return 100.0 * least / secs
