"""Share of the videos gated in whose FSD maps were fetched and cut (the
profile screen could not clear them): 100 x the program's `fsd_flagged`
counter over its `videos_gated_in`."""

from portbench.yardstick.spans import counter


def read(trace, rec=None):
    flagged, gated_in = counter("fsd_flagged", rec), counter("videos_gated_in", rec)
    if flagged is None or not gated_in:
        return None
    return 100.0 * flagged / gated_in
