"""The query pass's model FLOPs (every member, CLIP and the VSM) over the bf16 peak."""

from portbench.yardstick.readers import mfu


def read(trace):
    return mfu(trace)
