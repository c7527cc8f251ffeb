"""device_idle_pct.stream (%): the share of the traced window in which no
device operation ran (torch.profiler's device timeline)."""

from stegobench.readings import idle_pct as read  # noqa: F401
