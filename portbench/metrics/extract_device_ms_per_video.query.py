"""Device ms per query video under the extract members' forward ranges."""

from portbench.yardstick.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, "portbench::extract/", "videos")
