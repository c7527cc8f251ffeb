"""readback_share_pct.embed (%): the pipeline's device_readback stage (the
benchmark's stage timer: the pageable copy of each stego batch back to the
host, which waits for the batch's kernel) over the embed jobs' time."""

from stegobench.readings import stage_share_pct


def read(rec):
    return stage_share_pct(rec, "device_readback")
