"""Host ms per query video in the pipeline's own `fsd` stage (screen and cuts)."""

from portbench.yardstick.readers import program_span_ms_per


def read(trace):
    return program_span_ms_per(trace, "fsd")
