"""readback_share_pct.embed on a canned record: 0.03 s of device_readback
in 2 s of embed jobs."""

from stegobench.tests.test_stegobench_program_spans import program_record


def record():
    return program_record(stages={"device_readback": 0.03, "encode": 1.5})


def expected(rec):
    return 1.5
