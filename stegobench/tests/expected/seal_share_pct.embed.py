"""seal_share_pct.embed on a canned record: 0.01 s of seal in 2 s of embed
jobs."""

from stegobench.tests.test_stegobench_program_spans import program_record


def record():
    return program_record(stages={"seal": 0.01, "encode": 1.5})


def expected(rec):
    return 0.5
