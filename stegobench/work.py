"""The work a step must do, and the least time an H100 could take for it.

Frozen from ``stegotpu_torch/studies/bounds.py`` (``work``, ``bound_ms``),
keyed by step instead of by kernel, so that a roofline reads the same work
whatever kernels implement the step. Bytes count each input read once and
each output written once; operations are float32 operations, two per FMA,
of the separable 8-point DCT over the slot rows a block needs (num_ac // 8
+ 1 of its 8 rows), the least work of the function. The 256-byte DCT matrix
and the 4-byte bits per frame are left out: under a millionth of a step.

A step this file does not count is a file of its own,
``stegobench/steps/<step>.py``, defining ``work(h, w, num_ac) -> (bytes,
operations)`` of one frame by the same rules; like this file it imports
nothing of the program.

Peaks: NVIDIA H100 SXM data sheet, dense, at its full 700 W limit.
"""

from __future__ import annotations

from pathlib import Path

from stegobench import manifest

STEPS = Path(__file__).resolve().parent / "steps"

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def _transform_flops(h: int, w: int, num_ac: int) -> int:
    """Operations of one forward or inverse transform of one frame's slot
    rows: two passes of rn * 64 FMAs a block."""
    rn = num_ac // 8 + 1
    return (h // 8) * (w // 8) * 2 * 2 * rn * 64


def work(step: str, h: int, w: int, num_ac: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one frame of `step` at H x W.

    - file_embed: the frame and its payload bits (one uint8 a slot) read,
      the stego written; a forward and an inverse transform;
    - roundtrip: the same, and the extracted bits (one uint8 a slot)
      written; a third transform reads the stego back;
    - roundtrip_eval: roundtrip, whose PSNR and bit-error count reuse what
      the step already holds (three operations a pixel, two a slot); their
      scalars are under a millionth of the bytes;
    - any other step: the work(h, w, num_ac) of stegobench/steps/<step>.py.
    """
    pixels = h * w
    cap = (h // 8) * (w // 8) * num_ac
    t = _transform_flops(h, w, num_ac)
    if step == "file_embed":
        return 2 * pixels + cap, 2 * t
    if step == "roundtrip":
        return 2 * pixels + 2 * cap, 3 * t
    if step == "roundtrip_eval":
        return 2 * pixels + 2 * cap, 3 * t + 3 * pixels + 2 * cap
    path = STEPS / f"{step}.py"
    if not path.exists():
        raise KeyError(f"no work count for step {step!r}: add "
                       f"stegobench/steps/{step}.py defining work(h, w, num_ac)")
    mod = manifest.load_module(path,
                               "stegobench_step_" + step.replace(".", "_"))
    return mod.work(h, w, num_ac)


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """(least seconds on an H100 SXM, "bytes" or "operations")."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
