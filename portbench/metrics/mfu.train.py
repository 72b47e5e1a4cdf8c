"""The train step's model FLOPs (3 x forward, both views) over the bf16 peak."""

from portbench.yardstick.readers import mfu


def read(trace):
    return mfu(trace, passes=3)
