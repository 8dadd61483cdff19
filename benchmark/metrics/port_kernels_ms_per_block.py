"""Device time of the port's own CUDA kernels a block runs (layer:
kernels), ms a traced block; `benchmark/port_kernels.txt` names them."""


def read(trace):
    if not trace.blocks:
        return None
    secs = trace.seconds_of(trace.is_port_kernel)
    return secs * 1e3 / len(trace.blocks) if secs > 0 else None
