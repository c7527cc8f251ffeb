"""kernels_roofline_pct.stream (%): the traced steps' least time on an H100
(stegobench/work.py) over the device time of every operation they ran."""

from stegobench.readings import roofline_pct as read  # noqa: F401
