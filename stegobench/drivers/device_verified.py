"""The verified embed of letterboxed film at full capacity, on frames
already in device memory, then the extract: device_stream's closed loop.

Set-up makes a pool of distinct scope covers on the device from the seed
(``scope_covers``: bars of the configuration's ``letterbox_rows`` at
``letterbox_luma`` above and below the picture; in the picture, blocks flat
at 255 and at 0 in the configuration's shares, the rest textured mid-tones)
and payload bits at full capacity, at least ``pool_bytes_min`` bytes, and
warms the step on them. Each batch runs the program's
``ops/verified.embed_frames_verified_fast`` (K3, then the DC-shift repair
loop of every block that reads back wrong) and
``ops/stripe_kernel.extract_frames`` (K2 and the wire-order unpack) on its
stego. The residual is copied to pinned host memory without blocking and
read when the batch finishes; a batch with a residual counts in ``failed``.

Check, on a sample of the window's batches drawn from the seed, in parts of
CHECK_FRAMES frames: the stego against the plain reference's
(stegobench/reference_verified.py) where its answer is certain; the float64
reading of the program's stego against the payload on every valid slot
outside reference.near_boundary's envelope (the guarantee: every payload
bit reads back); the extracted bits against that reading; the bits per
frame; the program's residual against the reference's and against the
float64 reading of its own stego (each a count, give or take the slots
whose reading a float32 program could take either way); and, over every
batch of the window, the batches with a residual: the configuration allows
none (``allow_residual`` false), and a DC shift can repair every block of
these covers.
"""

from __future__ import annotations

from pathlib import Path

import torch

from stegobench import reference, reference_verified
from stegobench.core import Check
from stegobench.drivers import device_stream
from stegobench.tracing import Tracer

CHECK_FRAMES = device_stream.CHECK_FRAMES


def scope_covers(shape: tuple[int, ...], cfg: dict,
                 gen: torch.Generator, device) -> torch.Tensor:
    """(..., H, W) uint8 letterboxed covers from `gen`: rows [0, bars) and
    [H - bars, H) at the bar luma; in the picture between, each 8x8 block
    flat at 255 with probability highlight_share, flat at 0 with
    shadow_share, else a block base drawn in midtone_range narrowed by the
    texture on each side, plus uniform per-pixel texture in +-texture."""
    *lead, h, w = shape
    bars = cfg["letterbox_rows"]
    tex = cfg["texture"]
    lo, hi = cfg["midtone_range"]
    ph = h - 2 * bars
    out = torch.full(shape, cfg["letterbox_luma"], dtype=torch.uint8,
                     device=device)
    bshape = (*lead, ph // 8, w // 8)
    kind = torch.rand(bshape, generator=gen, device=device)
    base = torch.randint(lo + tex, hi - tex + 1, bshape, generator=gen,
                         device=device, dtype=torch.int16)
    base = base.repeat_interleave(8, -2).repeat_interleave(8, -1)
    pic = base + torch.randint(-tex, tex + 1, (*lead, ph, w), generator=gen,
                               device=device, dtype=torch.int16)
    del base
    kind = kind.repeat_interleave(8, -2).repeat_interleave(8, -1)
    high = cfg["highlight_share"]
    pic = torch.where(kind < high, 255, pic)
    pic = torch.where((kind >= high) & (kind < high + cfg["shadow_share"]),
                      0, pic)
    out[..., bars:h - bars, :] = pic.to(torch.uint8)
    return out


class Driver(device_stream.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: bool = False):
        super().__init__(cfg, traffic, seed, device, workdir, control)
        self.rounds = cfg["repair_rounds"]
        self.failed = 0

    def setup(self) -> None:
        per_batch = self.b * (self.h * self.w + self.cap)
        pool = max(2, -(-self.traffic["pool_bytes_min"] // per_batch))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed & 0xFFFF_FFFF_FFFF_FFFF)
        self.frames = torch.stack([
            scope_covers((self.b, self.h, self.w), self.cfg, gen, self.device)
            for _ in range(pool)])
        self.payload = torch.randint(0, 2, (pool, self.b, self.cap),
                                     generator=gen, device=self.device,
                                     dtype=torch.uint8)
        pin = self.device.type == "cuda"
        self.host = [torch.empty((), dtype=torch.int32, pin_memory=pin)
                     for _ in range(self.traffic["in_flight"])]
        for p in range(pool):   # every input once: the shapes, the pages
            self._step(p, 0, Tracer(False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, p: int, slot: int, tracer) -> tuple:
        frames, payload = self.frames[p], self.payload[p]
        with tracer.span("dispatch"):
            if self.control:
                stego, bpf, residual = control_embed(
                    frames, payload, self.total, self.delta, self.n,
                    self.rounds)
                extracted = reference.extract(stego, self.delta, self.n,
                                              "tf32")
            else:
                from stegotpu_torch.ops import stripe_kernel, verified

                stego, bpf, residual = verified.embed_frames_verified_fast(
                    frames, payload, self.total, self.delta, self.n,
                    repair_rounds=self.rounds)
                extracted = stripe_kernel.extract_frames(stego, self.delta,
                                                         self.n)
            host = self.host[slot]
            host.copy_(residual, non_blocking=True)
        return (p, stego, bpf, extracted, (host, _Residual(host, self)))

    def window(self, seconds: float, tracer, timer):
        self.failed = 0
        rec = super().window(seconds, tracer, timer)
        rec.failed = self.failed
        return rec

    def check(self, rec) -> list[Check]:
        px_wrong, payload_wrong, bits_wrong, bpf_wrong = 0, 0, 0, 0
        residual_wrong = 0
        for p, stego, bpf, extracted, (_, residual) in self.sample.items:
            frames, payload = self.frames[p], self.payload[p]
            ref_bpf = (self.total - torch.arange(self.b, device=self.device)
                       * self.cap).clamp(0, self.cap)
            bpf_wrong += int((bpf.to(torch.int64) != ref_bpf).sum())
            least, most = 0, 0   # the reference's residual, at least, most
            wrong, near = 0, 0   # slots the stego reads wrong, either way
            for f in range(0, self.b, CHECK_FRAMES):
                part = slice(f, f + CHECK_FRAMES)
                n = frames[part].shape[0]
                total = min(max(self.total - f * self.cap, 0), n * self.cap)
                ref = reference_verified.embed_verified(
                    frames[part], payload[part], total, self.delta, self.n,
                    self.rounds)
                px_wrong += int(((stego[part] != ref.stego) & ref.sure).sum())
                least += ref.residual
                most += ref.residual + ref.unsure
                del ref
                v = reference.slot_values(stego[part], self.delta, self.n,
                                          "f64")
                read = torch.remainder(torch.round(v), 2.0).to(torch.uint8)
                sure = ~reference.near_boundary(v, self.delta)
                valid = (torch.arange(n * self.cap, device=self.device)
                         < total).reshape(n, self.cap)
                bits_wrong += int(((read != extracted[part]) & sure).sum())
                wrong += int(((read != payload[part]) & sure & valid).sum())
                near += int((valid & ~sure).sum())
                del v, read, sure, valid
            payload_wrong += wrong
            residual_wrong += max(0, least - residual, residual - most,
                                  wrong - residual, residual - wrong - near)
        return [Check("stego_px_wrong", px_wrong, 0),
                Check("payload_bits_wrong", payload_wrong, 0),
                Check("bits_wrong", bits_wrong, 0),
                Check("bpf_wrong", bpf_wrong, 0),
                Check("residual_wrong", residual_wrong, 0),
                Check("batches_failed", rec.failed, 0)]


class _Residual:
    """A batch's residual in pinned host memory. The window reads it with
    int() once the batch's event has completed (device_stream's finish
    reads a batch's scalars so); a residual counts the batch as failed."""

    def __init__(self, host: torch.Tensor, driver: Driver):
        self.host, self.driver = host, driver

    def __int__(self) -> int:
        v = int(self.host)
        self.driver.failed += v > 0
        return v


def control_embed(frames, payload, total_bits, delta, num_ac, rounds):
    """The reference's verified embed in TF32 in the program's place, in
    parts of CHECK_FRAMES frames (a block is repaired on its own pixels, so
    the parts give the batch's answer)."""
    b, cap = payload.shape
    stego, bpf, residual = [], [], 0
    for f in range(0, b, CHECK_FRAMES):
        part = slice(f, f + CHECK_FRAMES)
        n = frames[part].shape[0]
        total = min(max(total_bits - f * cap, 0), n * cap)
        ref = reference_verified.embed_verified(
            frames[part], payload[part], total, delta, num_ac, rounds, "tf32")
        stego.append(ref.stego)
        bpf.append(ref.bpf)
        residual += ref.residual
    return (torch.cat(stego), torch.cat(bpf),
            torch.tensor(residual, dtype=torch.int32, device=frames.device))
