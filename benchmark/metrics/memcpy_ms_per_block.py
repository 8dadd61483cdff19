"""Device time of the host-to-device and device-to-host copies a block
makes (layer: entry), from the profiler's activities, ms a traced block."""


def read(trace):
    if not trace.blocks:
        return None
    return trace.seconds_of(trace.is_host_device_copy) * 1e3 / len(trace.blocks)
