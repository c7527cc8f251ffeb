"""dispatch_share_pct.embed (%): the pipeline's device_dispatch stage (the
benchmark's stage timer: the pageable copies of a batch's frames and bits
to the device and the embed kernel's launch) over the embed jobs' time."""

from stegobench.readings import stage_share_pct


def read(rec):
    return stage_share_pct(rec, "device_dispatch")
