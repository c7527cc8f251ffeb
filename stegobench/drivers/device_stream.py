"""The streaming round trip on frames already in device memory.

Set-up makes a pool of distinct batches on the device from the seed (luma
in the configuration's range, payload bits at full capacity) of at least
``pool_bytes_min`` bytes, so that the inputs come from HBM and not from
the L2, and warms the step on them. The window is a closed loop of
back-to-back batches, at most ``in_flight`` of them queued: each batch runs
the program's ``ops/stripe_kernel.embed_and_extract_frames`` (the fused
embed and re-extract, then the wire-order unpack) and, where the traffic
says ``evaluate``, ``ops/qim.roundtrip_metrics`` (PSNR and the bit-error
count on the device, both scalars copied to the host). A batch counts when
an event recorded after its last operation has completed.

Check, on a sample of the window's batches drawn from the seed, in parts
of CHECK_FRAMES frames so that the float64 reference fits beside them: the stego
against the plain reference's, within the float32 envelope; the extracted
bits against the reference's float64 reading of the program's stego,
outside the envelope of a rounding boundary; the bits per frame; with
``evaluate``, the bit-error count exactly and the PSNR against the float64
one of the program's stego.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path

import torch

from stegobench import reference
from stegobench.core import Check, Job, Record, Reservoir, rng
from stegobench.tracing import Tracer

# frames of a sampled batch that the float64 check holds at once
CHECK_FRAMES = 8


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.control = torch.device(device), control
        self.h, self.w = cfg["height"], cfg["width"]
        self.b, self.n = cfg["batch_frames"], cfg["num_ac"]
        self.delta = float(cfg["delta"])
        self.cap = reference.capacity(self.h, self.w, self.n)
        self.total = self.b * self.cap
        self.evaluate = bool(traffic["evaluate"])
        self.step = "roundtrip_eval" if self.evaluate else "roundtrip"

    def setup(self) -> None:
        per_batch = self.b * (self.h * self.w + self.cap)
        pool = max(2, -(-self.traffic["pool_bytes_min"] // per_batch))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed & 0xFFFF_FFFF_FFFF_FFFF)
        lo, hi = self.cfg["luma_range"]
        self.frames = torch.randint(lo, hi + 1, (pool, self.b, self.h, self.w),
                                    generator=gen, device=self.device,
                                    dtype=torch.uint8)
        self.payload = torch.randint(0, 2, (pool, self.b, self.cap),
                                     generator=gen, device=self.device,
                                     dtype=torch.uint8)
        pin = self.device.type == "cuda"
        self.host = [(torch.empty((), dtype=torch.float32, pin_memory=pin),
                      torch.empty((), dtype=torch.int64, pin_memory=pin))
                     for _ in range(self.traffic["in_flight"])]
        for p in range(pool):   # every input once: the shapes, the pages
            self._step(p, 0, Tracer(False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, p: int, slot: int, tracer) -> tuple:
        frames, payload = self.frames[p], self.payload[p]
        with tracer.span("dispatch"):
            if self.control:
                stego, bpf = reference.embed(frames, payload, self.total,
                                             self.delta, self.n, "tf32")
                extracted = reference.extract(stego, self.delta, self.n, "tf32")
            else:
                from stegotpu_torch.ops import stripe_kernel

                stego, bpf, extracted = stripe_kernel.embed_and_extract_frames(
                    frames, payload, self.total, self.delta, self.n)
        out = (p, stego, bpf, extracted, None)
        if self.evaluate:
            with tracer.span("eval"):
                if self.control:
                    psnr, errors = control_metrics(frames, stego, extracted,
                                                   payload, self.total)
                else:
                    from stegotpu_torch.ops.qim import roundtrip_metrics

                    m = roundtrip_metrics(frames, stego, extracted, payload,
                                          self.total)
                    psnr, errors = m["psnr_db"], m["bit_errors"]
                hp, he = self.host[slot]
                hp.copy_(psnr, non_blocking=True)
                he.copy_(errors, non_blocking=True)
            out = (p, stego, bpf, extracted, self.host[slot])
        return out

    def window(self, seconds: float, tracer, timer) -> Record:
        rec = Record(self.step, self.h, self.w, self.n)
        self.sample = Reservoir(self.traffic["sample_batches"],
                                rng(self.seed, 5))
        pool = self.frames.shape[0]
        cuda = self.device.type == "cuda"
        pending: deque = deque()
        jobs = rec.jobs

        def finish() -> None:
            t_launch, ev, out = pending.popleft()
            with tracer.span("sync"):
                if cuda:
                    ev.synchronize()
            if out[4] is not None:   # the scalars, read once they landed
                hp, he = out[4]
                out = (*out[:4], (float(hp), int(he)))
            jobs.append(Job(t_launch, time.perf_counter(), self.b))
            if tracer.active:
                rec.traced_frames += self.b
            self.sample.offer(out)

        def drain() -> None:
            while pending:
                finish()

        rec.t0 = t = time.perf_counter()
        i = 0
        while t - rec.t0 < seconds:
            tracer.tick(rec.t0, t, drain)
            if len(pending) >= self.traffic["in_flight"]:
                finish()
            t = time.perf_counter()
            out = self._step(i % pool, i % self.traffic["in_flight"], tracer)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            pending.append((t, ev, out))
            i += 1
            t = time.perf_counter()
        drain()
        tracer.close(drain)
        rec.t_end = jobs[-1].t1 if jobs else t
        rec.attempted = i
        return rec

    def check(self, rec: Record) -> list[Check]:
        lim = self.traffic["limits"]
        px_wrong, bits_wrong, bpf_wrong = 0, 0, 0
        errors_wrong, psnr_gap = 0, 0.0
        for p, stego, bpf, extracted, scalars in self.sample.items:
            frames, payload = self.frames[p], self.payload[p]
            ref_bpf = (self.total - torch.arange(self.b, device=self.device)
                       * self.cap).clamp(0, self.cap)
            bpf_wrong += int((bpf.to(torch.int64) != ref_bpf).sum())
            for f in range(0, self.b, CHECK_FRAMES):
                part = slice(f, f + CHECK_FRAMES)
                total = min(max(self.total - f * self.cap, 0),
                            frames[part].shape[0] * self.cap)
                ref, sure = reference.embed_envelope(
                    frames[part], payload[part], total, self.delta, self.n)
                px_wrong += int(((stego[part] != ref) & sure).sum())
                del ref, sure
                v = reference.slot_values(stego[part], self.delta, self.n,
                                          "f64")
                read = torch.remainder(torch.round(v), 2.0).to(torch.uint8)
                sure = ~reference.near_boundary(v, self.delta)
                bits_wrong += int(((read != extracted[part]) & sure).sum())
                del v, read, sure
            if scalars is not None:
                psnr, errors = scalars
                idx = torch.arange(self.b * self.cap, device=self.device)
                valid = (idx < self.total).reshape(self.b, self.cap)
                want = int((valid & (extracted != payload)).sum())
                errors_wrong += abs(errors - want)
                psnr_gap = max(psnr_gap, abs(psnr - reference.psnr_f64(
                    frames, stego, CHECK_FRAMES)))
        checks = [Check("stego_px_wrong", px_wrong, 0),
                  Check("bits_wrong", bits_wrong, 0),
                  Check("bpf_wrong", bpf_wrong, 0)]
        if self.evaluate:
            checks += [Check("bit_errors_wrong", errors_wrong, 0),
                       Check("psnr_gap_db", psnr_gap, lim["psnr_gap_db"])]
        return checks


def control_metrics(frames, stego, extracted, payload, total_bits):
    """The evaluation in the precision below the configuration's float32:
    the squared error and its mean in bfloat16."""
    d = (frames.to(torch.bfloat16) - stego.to(torch.bfloat16))
    m = (d * d).mean().float()
    psnr = 10.0 * torch.log10(255.0 * 255.0 / m)
    b, cap = payload.shape
    idx = torch.arange(b * cap, device=payload.device).reshape(b, cap)
    errors = ((idx < int(total_bits)) & (extracted != payload)).sum()
    return psnr, errors
