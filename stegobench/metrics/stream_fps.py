"""stream_fps (frames/s): frames of completed batches over the time from the
window's start to the completion of the last batch (host clock)."""

from stegobench.readings import fps as read  # noqa: F401
