"""MB (10^6 bytes) copied host to device per query video: the program's
`h2d_bytes` counter (the frames, the small index uploads, K3's operands)."""

from portbench.yardstick.spans import counter_per_video


def read(trace, rec=None):
    return counter_per_video(trace, "h2d_bytes", 1e-6, rec)
