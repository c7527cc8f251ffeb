"""Randomized PRODUCT-level soak: file -> file embed+extract round trips.

Counterpart of ``tools/soak_product.py``, with its draws from the same
``rng`` calls: resolution (incl. widths that are not multiples of 128),
frame count, secret size, delta/num_ac, codec, kernel, precision,
verified embed, batch size, and the --procs worker count and mode
(drawn only where the native concat layer is built, as there). Every draw
asserts the end-to-end contract: embed succeeds whenever capacity
suffices, extract recovers the secret PIXEL-IDENTICAL with the SHA3 hash
verifying, and a wrong-delta extract fails CLOSED (structured error,
never garbage output).

Usage: python -m stegotpu_torch.tools.soak_product [N] [SEED] [--device D]
(default 30 draws, seed 0, the card). Prints one JSON row a draw and a
summary; exit 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from stegotpu_torch.device import resolve_device


def one_draw(i: int, rng: np.random.Generator, workdir: Path,
             device) -> dict:
    from stegotpu_torch import crypto, fixtures
    from stegotpu_torch.config import StegoConfig
    from stegotpu_torch.image import load_image_gray
    from stegotpu_torch.native import videoio
    from stegotpu_torch.pipeline import (embed_image_in_video,
                                         extract_image_from_video)

    # dims: multiples of 8 after crop; mix 128-multiple and other widths
    w = int(rng.choice([128, 256, 384, 320, 336, 720, 160]))
    h = int(rng.choice([64, 96, 128, 120, 240, 480]))
    frames = int(rng.integers(6, 20))
    delta = float(rng.choice([8.0, 12.0, 20.0, 28.0]))
    num_ac = int(rng.choice([1, 3, 10, 17]))
    kernel = str(rng.choice(["pallas", "xla"]))
    precision = str(rng.choice(["wire", "fast"])) if delta >= 12 else "wire"
    codec = str(rng.choice(["FFV1", "HFYU", "RGBA"]))
    verified = bool(rng.integers(0, 2))
    batch = int(rng.choice([2, 4, 8]))
    procs = int(rng.choice([1, 1, 2, 3])) if videoio.available() else 1
    mode = str(rng.choice(["thread", "spawn"])) if procs > 1 else "thread"

    cap_bits = (h // 8) * (w // 8) * num_ac * frames
    if cap_bits < 4000:
        # tiny capacity draws can't even fit the ~1k-bit header with room
        # for a secret; bump num_ac rather than skip the draw
        num_ac = 10
        cap_bits = (h // 8) * (w // 8) * num_ac * frames
    # secret sized to fit with headroom (header ~1k + 8 bits/px)
    max_px = max(64, int((cap_bits - 2000) // 8))
    side = int(np.clip(rng.integers(8, 200), 8, np.floor(np.sqrt(max_px))))
    cfg = dict(delta=delta, num_ac_coeffs=num_ac, kernel=kernel,
               qim_precision=precision, codec=codec)
    d = workdir / f"draw{i}"
    d.mkdir()
    fixtures.make_cover_video(d / "c.mp4", w, h, frames=frames,
                              kind="moving", seed=int(rng.integers(1 << 30)))
    fixtures.make_secret_image(d / "s.png", side, side, kind="noise",
                               seed=int(rng.integers(1 << 30)))
    priv, pub_c = crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")

    row = dict(i=i, w=w, h=h, frames=frames, delta=delta, num_ac=num_ac,
               kernel=kernel, precision=precision, codec=codec,
               verified=verified, batch=batch, procs=procs, mode=mode,
               secret=side, device=str(device))
    t0 = time.perf_counter()
    embed_cfg = StegoConfig(verified_embed=verified, repair_rounds=3, **cfg)
    if procs > 1:
        from stegotpu_torch.parallel.local_procs import parallel_embed

        res = parallel_embed(d / "c.mp4", d / "s.png", d / "st", pub_c,
                             embed_cfg, batch_frames=batch, procs=procs,
                             mode=mode, device=device)
    else:
        res = embed_image_in_video(d / "c.mp4", d / "s.png", d / "st",
                                   pub_c, embed_cfg, batch_frames=batch,
                                   device=device)
    assert res.success, (row, getattr(res, "error", None))

    # cross-kernel extract: the wire must interoperate between the kernel
    # and the oracle, with the precision the embed used
    ext_kernel = str(rng.choice(["pallas", "xla"]))
    ext = extract_image_from_video(
        res.output_path, priv,
        StegoConfig(**{**cfg, "kernel": ext_kernel}),
        batch_frames=int(rng.choice([2, 4, 8])), device=device)
    assert ext.success, (row, ext.error)
    assert ext.hash_ok, row
    np.testing.assert_array_equal(ext.pixels, load_image_gray(d / "s.png"),
                                  err_msg=str(row))

    # fail-closed probe: wrong delta must produce a structured error
    bad = extract_image_from_video(
        res.output_path, priv,
        StegoConfig(**{**cfg, "delta": delta + 7.0}), device=device)
    assert not bad.success and bad.error, row

    row["wall_s"] = round(time.perf_counter() - t0, 2)
    # keep the workspace small across hundreds of draws
    for p in sorted(d.glob("*")):
        p.unlink()
    d.rmdir()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stegotpu_torch.tools.soak_product",
        description="random file-to-file embed/extract round trips")
    ap.add_argument("n", nargs="?", type=int, default=30,
                    help="draws (default 30)")
    ap.add_argument("seed", nargs="?", type=int, default=0,
                    help="rng seed (default 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    fails = 0
    with tempfile.TemporaryDirectory() as td:
        for i in range(args.n):
            try:
                row = one_draw(i, rng, Path(td), device)
                print(json.dumps(row), flush=True)
            except AssertionError as e:
                fails += 1
                print(f"FAIL draw {i}: {e}", file=sys.stderr, flush=True)
    print(f"product soak done: {args.n} draws, {fails} failures", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
