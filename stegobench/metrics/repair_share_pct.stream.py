"""repair_share_pct.stream (%): device time of the operations launched
inside the program's stegotpu_torch.verified.repair spans (the DC-shift
repair loop of ops/verified.py) over the traced steps' device time."""

from stegobench.readings import span_share_pct


def read(rec):
    return span_share_pct(rec, "stegotpu_torch.verified.repair")
