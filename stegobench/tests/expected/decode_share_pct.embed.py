"""decode_share_pct.embed on a canned record: 0.3 s of decode in 2 s of
embed jobs."""

from stegobench.tests.test_stegobench_program_spans import program_record


def record():
    return program_record(stages={"decode": 0.3, "decode_wait": 0.5})


def expected(rec):
    return 15.0
