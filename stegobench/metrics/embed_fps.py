"""embed_fps (frames/s): frames of whole embed jobs over the time from the
window's start to the end of the last job (host clock)."""

from stegobench.readings import fps as read  # noqa: F401
