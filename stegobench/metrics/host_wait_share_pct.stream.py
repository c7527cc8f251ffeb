"""host_wait_share_pct.stream (%): host seconds inside the program's
stegotpu_torch.host_wait spans (a call that blocks the host until the
device's queue drains), clipped to the traced window, over the window.

0 where the program's spans (names that start with "stegotpu_torch.") are
on the window's timeline but none of them is a host_wait; nothing without
a trace, without device time, or where the program records no spans."""

from stegobench.timeline import _union

PREFIX = "stegotpu_torch."
SPAN = PREFIX + "host_wait"


def read(rec):
    tl = rec.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    inside = [(max(a, tl.t0), min(b, tl.t1), name)
              for a, b, name, _ in tl.spans if a < tl.t1 and b > tl.t0]
    if not any(name.startswith(PREFIX) for _, _, name in inside):
        return None
    waits = _union([(a, b) for a, b, name in inside if name == SPAN])
    return 100.0 * sum(b - a for a, b in waits) / 1e6 / tl.window_s
