"""The share of the traced window in which no activity ran on the device
(layer: device): 1 minus the union of the activities' intervals over the
window."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s() / trace.window_s
