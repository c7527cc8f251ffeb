"""repair_share_pct.stream on a canned verified batch: K3 (100 us) and the
extract (100 us) launched outside the repair span, the repair loop's two
operations (300 + 200 us) inside it: 500 us of 700."""

from stegobench.tests.test_stegobench_program_spans import (_span, _x,
                                                            program_record)
from stegobench.timeline import WINDOW_SPAN

REPAIR = "stegotpu_torch.verified.repair"


def trace() -> dict:
    return {"traceEvents": [
        _span(WINDOW_SPAN, 1000, 1000),
        _span("dispatch", 1000, 900),
        _x("cuda_runtime", "cudaLaunchKernel", 1010, 2, correlation=1),
        _x("kernel", "qim_embed_check_kernel", 1020, 100, correlation=1),
        _span("stegotpu_torch.host_wait", 1015, 110),
        _span(REPAIR, 1130, 600),
        _x("cuda_runtime", "cudaLaunchKernel", 1140, 2, correlation=2),
        _x("kernel", "gemm_kernel", 1150, 300, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1200, 2, correlation=3),
        _x("kernel", "elementwise_kernel", 1450, 200, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1750, 2, correlation=4),
        _x("kernel", "qim_extract_packed_kernel", 1760, 100, correlation=4),
    ]}


def record():
    return program_record(trace())


def expected(rec):
    return 100 * 500 / 700
