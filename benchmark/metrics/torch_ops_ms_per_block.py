"""Device time of the PyTorch ops a block runs (layer: stages): every
activity that is neither a copy or memset nor one of the port's kernels
(cuFFT, top-k, sorts, elementwise ops), ms a traced block."""


def read(trace):
    if not trace.blocks:
        return None
    secs = trace.seconds_of(lambda n: not trace.is_copy(n) and not trace.is_port_kernel(n))
    return secs * 1e3 / len(trace.blocks)
