"""dispatch_share_pct.embed on a canned record: 0.05 s of device_dispatch
in 2 s of embed jobs."""

from stegobench.tests.test_stegobench_program_spans import program_record


def record():
    return program_record(stages={"device_dispatch": 0.05, "encode": 1.5})


def expected(rec):
    return 2.5
