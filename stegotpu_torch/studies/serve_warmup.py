"""What a fresh ``serve`` daemon's first /embed pays that its second does
not: a host-clock stage split of two identical requests.

The parent builds the kernel library and makes chip_smoke.py phase 15's
request in a temporary directory: a 12-frame 1920x1080 FFV1 ``moving``
cover, a 640x480 noise secret and a key pair (delta 20, num_ac 10, the
server's defaults). Then, ``--runs`` times, a fresh child process starts
as the daemon does (``server._warm`` on the card: the library loaded, the
CUDA context) and makes the /embed handler's calls twice, each split on
the host clock into:

  imports          the modules the handler imports (pipeline, crypto)
  video_probe      native.videoio.available(): the native FFmpeg library
                   loaded or, where it is missing, built or its build tried
  key              the public key loaded
  seal, files_open, decode_wait, device_dispatch, device_readback,
  encode, files_close
                   the pipeline's own stages (its ``timer``)
  other            the rest of embed_image_in_video: the secret's decode,
                   the PSNR

device_dispatch and device_readback hold the card's side (the copies to
and from the card, the K1 launch); every other stage is the host's. The
pipeline's decode stage runs on its decode thread, beside these: the row
gives it apart, as ``decode_thread_s``. Each row also names the
top-level packages the request imported first. One JSON row a request;
the first row names the card.

    python -m stegotpu_torch.studies.serve_warmup [--runs 2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from stegotpu_torch.studies import harness

ROOT = Path(__file__).resolve().parents[2]
H, W, FRAMES = 1080, 1920, 12


def make_request(d: Path, h: int = H, w: int = W) -> dict:
    """Phase 15's /embed body, its files written under `d`."""
    from stegotpu_torch import crypto, fixtures

    fixtures.make_cover_video(d / "cover.avi", w, h, frames=FRAMES,
                              kind="moving", codec="FFV1")
    fixtures.make_secret_image(d / "secret.png", 640 * w // 1920,
                               480 * h // 1080, kind="noise", seed=15)
    crypto.setup_receiver_keys(d / "k.pem", d / "p.pem")
    return {"cover": str(d / "cover.avi"), "secret": str(d / "secret.png"),
            "output": str(d / "stego"), "public_key": str(d / "p.pem")}


def split_requests(body: dict, device, n: int = 2) -> list[dict]:
    """The /embed handler's calls for `body`, made `n` times in this
    process, each split on the host clock (see the module docstring)."""
    from stegotpu_torch.server import _config_from
    from stegotpu_torch.utils.profiling import StageTimer

    rows = []
    for i in range(n):
        before = set(sys.modules)
        timer = StageTimer()
        t0 = time.perf_counter()
        with timer.stage("imports"):
            from stegotpu_torch import crypto
            from stegotpu_torch.native import videoio
            from stegotpu_torch.pipeline import embed_image_in_video
        with timer.stage("video_probe"):
            videoio.available()
        with timer.stage("key"):
            pub = crypto.serialize_public_compressed(
                crypto.load_public_pem(body["public_key"]))
        res = embed_image_in_video(body["cover"], body["secret"],
                                   body["output"], pub, _config_from(body),
                                   batch_frames=8, device=device, timer=timer)
        end = time.perf_counter()
        stages = dict(timer.totals)
        decode = stages.pop("decode", 0.0)
        stages["other"] = end - t0 - sum(stages.values())
        rows.append({
            "request": i + 1, "success": res.success,
            "total_s": end - t0,
            "stages_s": stages,
            "decode_thread_s": decode,
            "imported": sorted({m.split(".")[0]
                                for m in set(sys.modules) - before}),
        })
    return rows


def _child(d: Path, device) -> int:
    """A fresh process, as `python -m stegotpu_torch.cli serve` starts:
    the server warmed on the device, then two identical requests."""
    from stegotpu_torch import server
    from stegotpu_torch.device import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    server._warm(dev)
    warm = time.perf_counter() - t0
    body = json.loads((d / "body.json").read_text())
    for row in split_requests(body, dev):
        harness.emit({"warm_s": warm, **row})
    return 0


def main(argv=None) -> int:
    prog = "python -m stegotpu_torch.studies.serve_warmup"
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2,
                    help="fresh child processes, two requests each")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(Path(args.child), args.device)
    dev = harness.require_cuda(prog)
    if dev is None:
        return 1
    from stegotpu_torch.ops import _build

    harness.header("serve_warmup", dev, args)
    _build.build()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "body.json").write_text(json.dumps(make_request(d)))
        for run in range(args.runs):
            proc = subprocess.run(
                [sys.executable, "-m", "stegotpu_torch.studies.serve_warmup",
                 "--child", str(d)], cwd=d, env=env, capture_output=True,
                text=True, timeout=600)
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    harness.emit({"run": run + 1, **json.loads(line)})
            if proc.returncode:
                print(f"{prog}: child {run + 1} exited {proc.returncode}: "
                      f"{proc.stderr.strip()[-2000:]}", file=sys.stderr)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
