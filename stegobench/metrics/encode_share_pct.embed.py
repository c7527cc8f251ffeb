"""encode_share_pct.embed (%): the pipeline's encode stage (the benchmark's
stage timer) over the embed jobs' time."""

from stegobench.readings import stage_share_pct


def read(rec):
    return stage_share_pct(rec, "encode")
