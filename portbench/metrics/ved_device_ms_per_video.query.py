"""Device ms per query video under the VED gate's ranges (CLIP and the VSM)."""

from portbench.yardstick.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, "portbench::ved/", "videos")
