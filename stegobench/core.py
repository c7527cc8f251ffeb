"""What a driver hands the harness: the run's record and its checks."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Job:
    """One unit of work in the window: a file job or a device batch."""
    t0: float
    t1: float
    frames: int


@dataclasses.dataclass
class Record:
    """A run's window, read by the metric readers (stegobench/metrics/)."""
    step: str                  # work.py key of one unit's device work
    h: int
    w: int
    num_ac: int
    t0: float = 0.0            # window opened (host clock, seconds)
    t_end: float = 0.0         # last unit finished
    jobs: list[Job] = dataclasses.field(default_factory=list)
    stages: dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    traced_frames: int = 0     # frames whose device work lies in the trace
    timeline: object = None    # timeline.Timeline of the traced part
    setup_s: float = 0.0


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit: value <= limit passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


class Reservoir:
    """A sample of k items drawn from a stream, the same for the same seed:
    each item i >= k replaces a kept one with probability k / (i + 1).
    `drop` is called with every item that leaves or never enters."""

    def __init__(self, k: int, rng: np.random.Generator, drop=None):
        self.k, self.rng, self.drop = k, rng, drop
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                out, self.items[j] = self.items[j], item
            else:
                out = item
            if self.drop is not None:
                self.drop(out)
        self.seen += 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for one stream of a run's seed."""
    return np.random.default_rng([seed, *stream])
