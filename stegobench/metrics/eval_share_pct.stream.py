"""eval_share_pct.stream (%): device time of the operations launched inside
the benchmark's eval span over the traced steps' device time."""

from stegobench.readings import span_share_pct


def read(rec):
    return span_share_pct(rec, "eval")
