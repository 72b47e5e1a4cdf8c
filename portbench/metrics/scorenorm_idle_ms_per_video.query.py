"""Device idle ms per query video in the gaps that end at work launched
inside the program's `score_norm` span: the device waiting on score-norm's
host work."""

from portbench.yardstick.spans import gap_ms_per_video


def read(trace):
    return gap_ms_per_video(trace, "score_norm")
