"""Host ms per query video in the program's `score_norm` span (the query
side of score-norm: preparing the queries and the noise corpus, K3's
operands up, K3, the fetch and the bias appended)."""

from portbench.yardstick.spans import span_ms_per_video


def read(trace, rec=None):
    return span_ms_per_video(trace, "score_norm", rec)
