"""Device ms per train step under autograd's backward functions."""

from portbench.yardstick.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, "autograd::engine::evaluate_function", "steps")
