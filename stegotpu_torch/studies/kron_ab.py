"""The witness of K7 and K8: their first CUDA version, kept as a study.

``csrc/qim_kron_smem.cu`` holds K7 and K8 as they ran before their
redesign for Hopper (``kron_embed_smem_kernel`` and
``kron_extract_smem_kernel``: 64 threads an 8x8 block, one coefficient or
pixel each, K64 copied into shared memory by every CUDA block of 4
blocks). They replace no TPU kernel and no path of the product launches
them. Each output of theirs is the same fmaf chain as in the redesigned
kernels of ``csrc/qim_kron.cu`` (forward: c ascending from 0.0f; inverse:
r ascending from 0.0f), with the same QIM, so the two give the same bytes:
the zero-tolerance identity that ``chip_smoke.py`` phase 10 and
``tests/test_torch_cuda.py`` hold.

``embed_frames_kron_smem`` and ``extract_frames_kron_smem`` take the
arguments of ``kron_kernel.embed_frames_kron`` and ``extract_frames_kron``
and launch the witness on a CUDA tensor; on a CPU tensor they run K7's and
K8's plain versions. ``stripe_kernel.LAUNCHES`` counts the launches by
entry point.

    python -m stegotpu_torch.studies.kron_ab [--batch 8] [--large-batch 128]

holds K7 and K8 to the witness on the card at each batch (1080x1920 by
default) and times both, queued, in turns (witness, new, new, witness),
with each time's share of its bound (studies/bounds.py; K7's against the
separable transform and against the dense form it computes). At B=8 the
frames fit in the 50 MB L2; at B=128 they do not.

``--stages`` then times where K7's time goes: ``csrc/qim_kron.cu`` is
built again once per entry of ``STAGES``, each with one stage of K7 taken
out by an edit of its text (their output is wrong; only their time is
read), beside the library's ``qim_stripe.cu``, under ``_build/kron_ab/``,
all nvcc at once. K7 of the library and of each build are timed in turns,
forward and backward, queued over --batch input sets at 1080x1920 that
together exceed the L2 (those of studies/stripe_cap.py).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import shutil
import sys

import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.ops import _build
from stegotpu_torch.ops import stripe_kernel as sk
from stegotpu_torch.ops.experimental import kron_kernel as kk
from stegotpu_torch.studies import bounds, harness, sass, stripe_cap


def embed_frames_kron_smem(frames: torch.Tensor, payload_bits: torch.Tensor,
                           total_bits: int, delta: float, num_ac: int,
                           bit_offset: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The witness of K7: (stego (B, H, W) uint8, bits per frame (B,)
    int32), the arguments and results of kron_kernel.embed_frames_kron."""
    b, h, w = kk._check_domain(frames, delta)
    cap = sk._check_payload(payload_bits, frames, num_ac)
    if frames.device.type == "cpu":
        return kk.embed_frames_kron_plain(frames, payload_bits, total_bits,
                                          delta, num_ac, bit_offset)
    stego = torch.empty_like(frames)
    if stego.numel():
        dev = frames.device
        sk.launch("stegotpu_kron_embed_smem", frames.data_ptr(),
                  payload_bits.data_ptr(), stego.data_ptr(),
                  kk._kron_on(dev).data_ptr(), dev.index, b, h, w, num_ac,
                  int(total_bits), int(bit_offset), float(delta),
                  sk._stream(dev))
    return stego, sk._bits_per_frame(b, cap, int(total_bits), int(bit_offset),
                                     frames.device)


def extract_frames_kron_smem(frames: torch.Tensor, delta: float,
                             num_ac: int) -> torch.Tensor:
    """The witness of K8: (B, C) uint8 wire-order slot bits, as
    kron_kernel.extract_frames_kron."""
    b, h, w = kk._check_domain(frames, delta)
    if frames.device.type == "cpu":
        return kk.extract_frames_kron_plain(frames, delta, num_ac)
    bits = torch.empty((b, (h // BLOCK) * (w // BLOCK) * num_ac),
                       dtype=torch.uint8, device=frames.device)
    if bits.numel():
        dev = frames.device
        sk.launch("stegotpu_kron_extract_smem", frames.data_ptr(),
                  bits.data_ptr(), kk._kron_on(dev).data_ptr(), dev.index, b,
                  h, w, num_ac, float(delta), sk._stream(dev))
    return bits


def same_bytes(frames: torch.Tensor, payload: torch.Tensor, total: int,
               delta: float, num_ac: int, bit_offset: int = 0) -> bool:
    """K7 and K8 against the witness on one input: stego, bits per frame,
    and K8's bits of the cover and of the stego, all equal."""
    s_new, bpf_new = kk.embed_frames_kron(frames, payload, total, delta,
                                          num_ac, bit_offset)
    s_old, bpf_old = embed_frames_kron_smem(frames, payload, total, delta,
                                            num_ac, bit_offset)
    return (torch.equal(s_new, s_old) and torch.equal(bpf_new, bpf_old)
            and all(torch.equal(kk.extract_frames_kron(x, delta, num_ac),
                                extract_frames_kron_smem(x, delta, num_ac))
                    for x in (frames, s_new)))


# K7 with one stage taken out, for --stages: name -> the edits (text of
# csrc/qim_kron.cu, its replacement) that take it out
STAGES = {
    "no_qim": [("    if (g < blocks && rem > 0) {", "    if (false) {")],
    "no_inverse": [("    micro_gemm(xs, ks, ty, tx, acc);  // X' = Y_new K64\n",
                    "")],
    "no_load": [("    if (g < blocks) load_rows(frames + at, w, raw);",
                 "    for (int r = 0; r < 8; ++r) raw[r] = make_uint2(t, r);")],
    "no_store": [("        *reinterpret_cast<uint32_t*>(stego + o) = lo;\n"
                  "        *reinterpret_cast<uint32_t*>(stego + o + 4 * "
                  "static_cast<size_t>(w)) = hi;",
                  "        if ((lo ^ hi) == 0xdeadbeefu) "
                  "*reinterpret_cast<uint32_t*>(stego + o) = lo;")],
    "one_cta": [("  const long long resident = static_cast<long long>(sms) "
                 "* per_sm;",
                 "  const long long resident = sms;")],
}


def stage_source(name: str) -> str:
    """csrc/qim_kron.cu with STAGES[name]'s edits, each of whose texts must
    occur in it exactly once."""
    text = (_build.CSRC / "qim_kron.cu").read_text()
    for old, new in STAGES[name]:
        if text.count(old) != 1:
            raise ValueError(f"stage {name}: {old!r} occurs "
                             f"{text.count(old)} times in qim_kron.cu")
        text = text.replace(old, new)
    return text


def build_stages() -> dict[str, tuple[ctypes.CDLL, dict]]:
    """Each stage's build, bound, and its ptxas report."""
    def one(name: str):
        d = _build.BUILD_DIR / "kron_ab" / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "qim_kron.cu").write_text(stage_source(name))
        out = d / _build.LIB_NAME
        log = _build._compile([d / "qim_kron.cu", _build.CSRC / "qim_stripe.cu"],
                              out)
        return name, _build.bind(ctypes.CDLL(str(out))), sass.ptxas(log)

    with concurrent.futures.ThreadPoolExecutor(len(STAGES)) as pool:
        return {name: (lib, regs) for name, lib, regs in pool.map(one, STAGES)}


def time_stages(dev: torch.device, args) -> None:
    """K7 of the library and of each STAGES build, timed in turns."""
    builds = {"library": (_build.load_library(), {}), **build_stages()}
    b, h, w, n = args.batch, args.height, args.width, harness.NUM_AC
    sets = stripe_cap.cold_sets(dev, b, h, w, n)
    fns = [lambda s=s: kk.embed_frames_kron(s[0], s[1], s[2], harness.DELTA, n)
           for s in sets]
    ms = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with stripe_cap.using(builds[name][0]):
            ms[name].append(harness.queued_ms(fns, runs=2 * len(sets)))
    base = sum(ms["library"]) / len(ms["library"])
    for name, runs in ms.items():
        mean = sum(runs) / len(runs)
        harness.emit({"stage": name, "batch": b, "sets": len(sets),
                      "k7_ms_runs": runs, "k7_ms": mean,
                      "saved_ms": base - mean,
                      "ptxas": {k: list(v) for k, v in builds[name][1].items()
                                if k.startswith("kron_embed")}})


def parse_args(argv=None):
    ap = harness.parser("Hold K7 and K8 to their first CUDA version byte for "
                        "byte and time both on the card.", 8)
    ap.add_argument("--large-batch", type=int, default=128,
                    help="a second batch, timed after --batch (0: none)")
    ap.add_argument("--stages", action="store_true",
                    help="then time K7 with each of its stages taken out")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.large_batch < 0 or args.iters < 1:
        ap.error("--batch and --iters take a positive count, --large-batch "
                 "one >= 0")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = harness.require_cuda("kron_ab")
    if dev is None:
        return 2
    h, w, n, delta = args.height, args.width, harness.NUM_AC, harness.DELTA
    harness.header("kron_ab", dev, args)
    ok = True
    for b in (args.batch, args.large_batch):
        if not b:
            continue
        frames, payload = harness.inputs(dev, b, h, w)
        total = b * payload.shape[1] - 13  # ends mid-block in the last frame
        same = same_bytes(frames, payload, total, delta, n)
        harness.emit({"batch": b, "check": "K7 (stego, bpf) and K8 bits == "
                      "the witness's", "ok": same})
        ok &= same
        calls = {
            "K7": {"witness": lambda: embed_frames_kron_smem(
                       frames, payload, total, delta, n),
                   "new": lambda: kk.embed_frames_kron(
                       frames, payload, total, delta, n)},
            "K8": {"witness": lambda: extract_frames_kron_smem(
                       frames, delta, n),
                   "new": lambda: kk.extract_frames_kron(frames, delta, n)}}
        for kernel, fns in calls.items():
            ms = {"witness": [], "new": []}
            for arm in ("witness", "new", "new", "witness"):
                ms[arm].append(harness.queued_ms(fns[arm], runs=args.iters))
            old, new = (sum(v) / len(v) for v in (ms["witness"], ms["new"]))
            work = "kron_embed" if kernel == "K7" else "kron_extract"
            # the kron kernels have no stripe: any divisor of H will do
            bound, by = bounds.bound_ms(*bounds.work(work, b, h, w, n, BLOCK))
            row = {"batch": b, "kernel": kernel, "witness_ms": old,
                   "new_ms": new, "witness_ms_runs": ms["witness"],
                   "new_ms_runs": ms["new"], "speedup": old / new,
                   "bound_ms": bound, "bound_by": by, "share": bound / new}
            if kernel == "K7":
                dense, _ = bounds.bound_ms(*bounds.work(
                    "kron_embed_dense", b, h, w, n, BLOCK))
                row.update(bound_ms_dense=dense, share_dense=dense / new)
            harness.emit(row)
        del frames, payload
    if args.stages:
        time_stages(dev, args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
