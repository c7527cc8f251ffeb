"""File-to-file embed of an image secret: a closed loop of one client.

Each job embeds a seeded gray secret (a PNG) into one of the seeded covers
(mp4v files made in set-up, taken in turn) through the program's
``pipeline.embed_image_in_video``, sealed for the run's receiver, and
writes an FFV1 AVI. The sealing's random bytes come from a generator of
the job's own (seed, job) stream, which the check hands the reference too.

Check, on a sample of the window's jobs drawn from the seed: the stego
file as written against the plain reference (stegobench/reference.py):
the payload frame's luma within the float32 envelope, every other frame
and channel exact, the payload bits the reference reads from it, and the
secret the reference opens from those bits with the receiver's key.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from stegobench import media, reference
from stegobench.core import Check, Job, Record, Reservoir, rng

STEP = "file_embed"


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.dir, self.control = device, workdir, control
        self.h, self.w = cfg["height"], cfg["width"]

    # --- inputs ---------------------------------------------------------------

    def setup(self) -> None:
        from stegotpu_torch.config import StegoConfig

        cfg, tr = self.cfg, self.traffic
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
        self.secrets = []
        for k in range(tr["secrets"]):
            px = media.secret(tr["secret_size"], rng(self.seed, 3, k))
            path = self.dir / f"secret{k}.png"
            media.write_png(path, px)
            self.secrets.append((path, px))
        # warm-up on the shapes the window uses: the first batch of a job
        # (decode, K1, sealing, FFV1 encode), not its pass-through tail
        self._job(-1, self.dir / "warmup.avi", None,
                  frame_range=(0, cfg["batch_frames"]))

    def _job(self, i: int, out: Path, timer, frame_range=None) -> bool:
        cover = self.covers[i % len(self.covers)]
        secret, _ = self.secrets[i % len(self.secrets)]
        seal_rng = rng(self.seed, 4, i + 1)
        if self.control:
            return reference_file_embed(cover, secret, out, self.pub, seal_rng,
                                        self.cfg)
        from stegotpu_torch.pipeline import embed_image_in_video

        res = embed_image_in_video(cover, secret, out, self.pub, self.config,
                                   batch_frames=self.cfg["batch_frames"],
                                   rng=seal_rng, timer=timer,
                                   frame_range=frame_range,
                                   device=self.device)
        return bool(res.success)

    # --- the window -----------------------------------------------------------

    def window(self, seconds: float, tracer, timer) -> Record:
        rec = Record(STEP, self.h, self.w, self.cfg["num_ac"])
        self.sample = Reservoir(self.traffic["sample_jobs"], rng(self.seed, 5),
                                drop=lambda item: item[1].unlink(missing_ok=True))
        self.failed_jobs = 0
        rec.t0 = t = time.perf_counter()
        i = 0
        while t - rec.t0 < seconds:
            tracer.tick(rec.t0, t, _nothing)
            t = time.perf_counter()
            out = self.dir / f"job{i}.avi"
            ok = self._job(i, out, timer)
            t1 = time.perf_counter()
            rec.jobs.append(Job(t, t1, self.cfg["frames"]))
            self.failed_jobs += not ok
            self.sample.offer((i, out))
            i, t = i + 1, t1
        tracer.close(_nothing)
        rec.t_end = t
        rec.attempted, rec.failed = i, self.failed_jobs
        return rec

    # --- the check ------------------------------------------------------------

    def check(self, rec: Record) -> list[Check]:
        cfg = self.cfg
        delta, n = float(cfg["delta"]), cfg["num_ac"]
        cap = reference.capacity(self.h, self.w, n)
        px_wrong, frames_wrong, bits_wrong, secret_wrong = 0, 0, 0, 0
        for i, out in self.sample.items:
            cover = media.read_frames(self.covers[i % len(self.covers)])
            _, px = self.secrets[i % len(self.secrets)]
            bits = reference.seal(px, self.pub, rng(self.seed, 4, i + 1))
            total = bits.size
            try:
                got = media.read_frames(out)
            except IOError:
                got = np.zeros((0, *cover.shape[1:]), np.uint8)
            # frames the payload spans carry the stego luma in all three
            # channels; the rest are the cover's frames as decoded
            span = -(-total // cap)
            missing = max(0, cover.shape[0] - got.shape[0])
            frames_wrong += missing * cover[0].size
            m = min(cover.shape[0], got.shape[0])
            frames_wrong += int((got[span:m] != cover[span:m]).sum())
            stego = got[:span, ..., 0] if m >= span else None
            if stego is None:
                frames_wrong += span * cover[0].size
                bits_wrong += total
                secret_wrong += px.size
                continue
            frames_wrong += int((got[:span] != stego[..., None]).sum())
            seg = np.zeros(span * cap, np.uint8)
            seg[:total] = bits
            ref, sure = reference.embed_envelope(
                torch.from_numpy(reference.gray(cover[:span])),
                torch.from_numpy(seg.reshape(span, cap)), total, delta, n)
            px_wrong += int(((torch.from_numpy(stego) != ref) & sure).sum())
            read = reference.extract(torch.from_numpy(stego), delta, n)
            read = read.numpy().reshape(-1)[:total]
            bits_wrong += int((read != bits).sum())
            opened = reference.open_sealed(read, self.receiver)
            secret_wrong += (px.size if opened is None or opened.shape != px.shape
                             else int((opened != px).sum()))
        return [Check("stego_px_wrong", px_wrong, 0),
                Check("frames_px_wrong", frames_wrong, 0),
                Check("payload_bits_wrong", bits_wrong, 0),
                Check("secret_px_wrong", secret_wrong, 0),
                Check("jobs_failed", self.failed_jobs, 0)]


def _nothing() -> None:
    """Nothing to drain: a file job leaves no device work behind."""


def reference_file_embed(cover: Path, secret: Path, out: Path, pub: bytes,
                         seal_rng, cfg: dict, precision: str = "tf32") -> bool:
    """The plain reference in the program's place: the same file embed,
    its transform in `precision` (the control)."""
    frames = media.read_frames(cover)
    px = media.read_png(secret)
    bits = reference.seal(px, pub, seal_rng)
    h, w = cfg["height"], cfg["width"]
    cap = reference.capacity(h, w, cfg["num_ac"])
    span = -(-bits.size // cap)
    seg = np.zeros(span * cap, np.uint8)
    seg[:bits.size] = bits
    stego, _ = reference.embed(torch.from_numpy(reference.gray(frames[:span])),
                               torch.from_numpy(seg.reshape(span, cap)),
                               bits.size, float(cfg["delta"]), cfg["num_ac"],
                               precision)
    frames = frames.copy()
    frames[:span] = stego.numpy()[..., None]
    media.write_frames(out, frames, cfg["fps"], cfg["codec"])
    return True
