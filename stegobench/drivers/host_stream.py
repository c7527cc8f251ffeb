"""The 4K round trip through the program's array API on numpy frames: a
closed loop of one client.

Set-up makes ``pool_batches`` distinct batches from the seed on the device
(the same draws as device_stream's: luma in the configuration's range,
payload bits at full capacity) and keeps them as numpy arrays on the host
(``frames``, ``payload``; the check moves them to the device), then warms
the step on each. Each batch calls the program's
``pipeline.embed_payload_into_gray_frames`` (a pageable copy of the frames
and bits to the card, K1, a pageable copy of the stego back) and
``pipeline.extract_bits_from_gray_frames`` on the stego it returned (a
pageable copy in, K2 and the wire-order unpack, the bits back). A batch
counts when its bits are on the host.

Check: device_stream's, on the sampled batches moved to the device (the
stego within the float64 embed's envelope, the extracted bits against the
float64 reading of the stego, the bits per frame).
"""

from __future__ import annotations

import numpy as np
import torch

from stegobench import reference
from stegobench.core import Check
from stegobench.drivers import device_stream
from stegobench.tracing import Tracer


class Driver(device_stream.Driver):
    def setup(self) -> None:
        from stegotpu_torch.config import StegoConfig

        self.config = StegoConfig(delta=int(self.cfg["delta"]),
                                  num_ac_coeffs=self.n)
        pool = self.traffic["pool_batches"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed & 0xFFFF_FFFF_FFFF_FFFF)
        lo, hi = self.cfg["luma_range"]
        frames = torch.randint(lo, hi + 1, (pool, self.b, self.h, self.w),
                               generator=gen, device=self.device,
                               dtype=torch.uint8)
        payload = torch.randint(0, 2, (pool, self.b, self.cap),
                                generator=gen, device=self.device,
                                dtype=torch.uint8)
        self.frames, self.payload = frames.cpu().numpy(), payload.cpu().numpy()
        del frames, payload
        for p in range(pool):   # every input once: the shapes, the pages
            self._step(p, 0, Tracer(False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, p: int, slot: int, tracer) -> tuple:
        frames, bits = self.frames[p], self.payload[p].reshape(-1)
        with tracer.span("dispatch"):
            if self.control:
                stego, bpf, extracted = control_roundtrip(
                    frames, bits, self.total, self.delta, self.n, self.device)
            else:
                from stegotpu_torch import pipeline

                stego, bpf = pipeline.embed_payload_into_gray_frames(
                    frames, bits, self.config, device=self.device)
                extracted = pipeline.extract_bits_from_gray_frames(
                    stego, self.config, device=self.device)
        return (p, stego, bpf, extracted, None)

    def check(self, rec) -> list[Check]:
        dev = self.device
        self.frames = torch.from_numpy(self.frames).to(dev)
        self.payload = torch.from_numpy(self.payload).to(dev)
        self.sample.items = [
            (p, torch.from_numpy(stego).to(dev), torch.from_numpy(bpf).to(dev),
             torch.from_numpy(bits).reshape(self.b, self.cap).to(dev), None)
            for p, stego, bpf, bits, _ in self.sample.items]
        return super().check(rec)


def control_roundtrip(frames: np.ndarray, bits: np.ndarray, total_bits: int,
                      delta: float, num_ac: int, device):
    """The reference in TF32 in the program's place, with the same copies:
    the numpy frames and bits to the device, the embed and the extract
    there, the stego, bits per frame and bits back."""
    f = torch.from_numpy(frames).to(device)
    b = torch.from_numpy(bits).reshape(f.shape[0], -1).to(device)
    stego, bpf = reference.embed(f, b, total_bits, delta, num_ac, "tf32")
    extracted = reference.extract(stego, delta, num_ac, "tf32")
    return (stego.cpu().numpy(), bpf.cpu().numpy(),
            extracted.cpu().numpy().reshape(-1))
