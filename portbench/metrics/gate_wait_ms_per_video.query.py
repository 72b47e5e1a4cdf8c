"""Host ms per query video that `process_many` waits on its worker thread's
half of the next batch (the gating fetch, the FSD screen and cuts): the
program's `gate_wait` span."""

from portbench.yardstick.spans import span_ms_per_video


def read(trace, rec=None):
    return span_ms_per_video(trace, "gate_wait", rec)
