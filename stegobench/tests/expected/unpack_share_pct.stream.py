"""unpack_share_pct.stream on the program's canned trace: its unpack span
launched 400 us of the steps' 600 us of device time."""

from stegobench.tests.test_stegobench_program_spans import (program_record,
                                                            program_trace)


def record():
    return program_record(program_trace())


def expected(rec):
    return 100 * 400 / 600
