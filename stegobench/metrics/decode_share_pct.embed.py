"""decode_share_pct.embed (%): the pipeline's decode stage (the benchmark's
stage timer, on the pipeline's decode thread) over the embed jobs' time."""

from stegobench.readings import stage_share_pct


def read(rec):
    return stage_share_pct(rec, "decode")
