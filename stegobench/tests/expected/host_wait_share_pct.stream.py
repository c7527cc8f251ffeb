"""host_wait_share_pct.stream on the program's canned trace: host waits
hold 730 us of its 1000 us window, clipped to it and nested counted once."""

from stegobench.tests.test_stegobench_program_spans import (program_record,
                                                            program_trace)


def record():
    return program_record(program_trace())


def expected(rec):
    return 73.0
