"""File-to-file embed of raw bytes at the cover's full capacity: a closed
loop of one client.

Each job seals one of a pool of seeded payloads (random bytes, made in
set-up, taken in turn) for the run's receiver and embeds it into one of the
seeded covers (mp4v files made in set-up, taken in turn) through the
program's ``pipeline.embed_data_in_video``, writing an FFV1 AVI. The
payload fills every slot of every frame: the configuration's
``payload_bytes`` plus the wire format's header are exactly the cover's
capacity (set-up refuses any other size). The sealing's random bytes come
from a generator of the job's own (seed, job) stream, which the check hands
the reference too. A job fails unless the program reports success, every
bit of the cover's capacity embedded and every frame used.

Check, on a sample of the window's jobs drawn from the seed, the reference
on the run's device in plain torch, 8 frames at a time: the stego file as
written against the plain reference (stegobench/reference.py and
reference_data.py): every frame's luma within the float64 embed's envelope,
the frame count and every channel equal to the luma, the payload bits the
reference reads from it, and the bytes the reference opens from those bits
with the receiver's key.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from stegobench import media, reference, reference_data
from stegobench.core import Check, Record, rng
from stegobench.drivers import file_embed

# frames the reference holds on the device at once
CHECK_FRAMES = 8


class Driver(file_embed.Driver):
    """file_embed's closed loop (its window) over jobs of raw bytes."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: bool = False):
        super().__init__(cfg, traffic, seed, device, workdir, control)
        self.cap = reference.capacity(self.h, self.w, cfg["num_ac"])
        self.total = cfg["frames"] * self.cap

    # --- inputs ---------------------------------------------------------------

    def setup(self) -> None:
        from stegotpu_torch.config import StegoConfig

        cfg, tr = self.cfg, self.traffic
        nbytes = cfg["payload_bytes"]
        sealed = reference_data.HEADER_BITS + 8 * nbytes
        if sealed != self.total:
            raise ValueError(
                f"{nbytes} bytes seal to {sealed} bits, not the {self.total} "
                f"of {cfg['frames']} frames at {self.w}x{self.h}: the payload "
                "must fill the cover exactly")
        self.config = StegoConfig(delta=cfg["delta"],
                                  num_ac_coeffs=cfg["num_ac"],
                                  dims_bits=cfg["dims_bits"], codec=cfg["codec"])
        self.receiver = reference.receiver_key(rng(self.seed, 1))
        self.pub = reference.public_compressed(self.receiver)
        self.covers = []
        for k in range(tr["covers"]):
            path = self.dir / f"cover{k}.mp4"
            media.write_cover(path, self.h, self.w, cfg["frames"], cfg["fps"],
                              rng(self.seed, 2, k), cfg["cover_codec"])
            self.covers.append(path)
        self.payloads = [rng(self.seed, 3, k).bytes(nbytes)
                         for k in range(tr["payloads"])]
        # warm-up: one whole job, every batch of it on the window's shapes
        self._job(-1, self.dir / "warmup.avi", None)

    def _job(self, i: int, out: Path, timer) -> bool:
        cover = self.covers[i % len(self.covers)]
        data = self.payloads[i % len(self.payloads)]
        seal_rng = rng(self.seed, 4, i + 1)
        if self.control:
            return reference_file_embed_data(cover, data, out, self.pub,
                                             seal_rng, self.cfg, self.device)
        from stegotpu_torch.pipeline import embed_data_in_video

        res = embed_data_in_video(cover, data, out, self.pub, self.config,
                                  batch_frames=self.cfg["batch_frames"],
                                  rng=seal_rng, timer=timer,
                                  device=self.device)
        return (bool(res.success) and res.bits_embedded == self.total
                and res.frames_used == self.cfg["frames"])

    # --- the check ------------------------------------------------------------

    def check(self, rec: Record) -> list[Check]:
        cfg = self.cfg
        delta, n_ac, frames = float(cfg["delta"]), cfg["num_ac"], cfg["frames"]
        dev = torch.device(self.device)
        px_wrong, frames_wrong, bits_wrong, data_wrong = 0, 0, 0, 0
        for i, out in self.sample.items:
            cover = reference.gray(media.read_frames(
                self.covers[i % len(self.covers)]))
            data = self.payloads[i % len(self.payloads)]
            bits = reference_data.seal_data(data, self.pub,
                                            rng(self.seed, 4, i + 1))
            try:
                got = media.read_frames(out)
            except IOError:
                got = np.zeros((0, self.h, self.w, 3), np.uint8)
            # every frame carries the stego luma in all three channels
            m = min(frames, got.shape[0])
            frames_wrong += abs(got.shape[0] - frames) * self.h * self.w * 3
            frames_wrong += int((got[:m] != got[:m, ..., :1]).sum())
            read = [np.zeros(0, np.uint8)]
            for f in range(0, m, CHECK_FRAMES):
                k = min(CHECK_FRAMES, m - f)
                seg = torch.from_numpy(
                    bits[f * self.cap:(f + k) * self.cap].reshape(k, self.cap))
                ref, sure = reference.embed_envelope(
                    torch.from_numpy(cover[f:f + k]).to(dev), seg.to(dev),
                    bits.size - f * self.cap, delta, n_ac)
                stego = torch.from_numpy(
                    np.ascontiguousarray(got[f:f + k, ..., 0])).to(dev)
                px_wrong += int(((stego != ref) & sure).sum())
                read.append(reference.extract(stego, delta, n_ac)
                            .cpu().numpy().reshape(-1))
            read = np.concatenate(read)
            bits_wrong += int((read != bits[:read.size]).sum()) \
                + bits.size - read.size
            opened = reference_data.open_data(read, self.receiver)
            if opened is None:
                data_wrong += len(data)
            else:
                a = np.frombuffer(opened, np.uint8)
                b = np.frombuffer(data, np.uint8)
                c = min(a.size, b.size)
                data_wrong += int((a[:c] != b[:c]).sum()) + abs(a.size - b.size)
        return [Check("stego_px_wrong", px_wrong, 0),
                Check("frames_px_wrong", frames_wrong, 0),
                Check("payload_bits_wrong", bits_wrong, 0),
                Check("data_bytes_wrong", data_wrong, 0),
                Check("jobs_failed", self.failed_jobs, 0)]


def reference_file_embed_data(cover: Path, data: bytes, out: Path, pub: bytes,
                              seal_rng, cfg: dict, device: str,
                              precision: str = "tf32") -> bool:
    """The plain reference in the program's place: the same full-capacity
    data embed, on `device`, CHECK_FRAMES frames at a time, its transform in
    `precision` (the control)."""
    dev = torch.device(device)
    gray = reference.gray(media.read_frames(cover))
    bits = reference_data.seal_data(data, pub, seal_rng)
    n, cap = gray.shape[0], bits.size // gray.shape[0]
    plane = bits.reshape(n, cap)
    stego = np.empty_like(gray)
    for f in range(0, n, CHECK_FRAMES):
        k = min(CHECK_FRAMES, n - f)
        s, _ = reference.embed(torch.from_numpy(gray[f:f + k]).to(dev),
                               torch.from_numpy(plane[f:f + k]).to(dev),
                               k * cap, float(cfg["delta"]), cfg["num_ac"],
                               precision)
        stego[f:f + k] = s.cpu().numpy()
    media.write_frames(out, np.repeat(stego[..., None], 3, -1), cfg["fps"],
                       cfg["codec"])
    return True
