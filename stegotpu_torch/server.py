"""Local HTTP serving daemon: warm-process embed/extract over JSON.

Counterpart of ``stegotpu/server.py``, with its routes, request fields,
defaults, response keys, status codes and guards, run through
``stegotpu_torch``: the QIM kernels on the card, crypto, framing and
codecs on the host. One process keeps the CUDA context and the built
kernel library warm, and exposes the pipelines to local tooling as a tiny
JSON-over-HTTP API (stdlib only):

    POST /embed    {"cover": ..., "secret": ..., "output": ...,
                    "delta": 20, "coeffs": 10, "codec": "FFV1",
                    "verified": false, "precision": "wire",
                    "public_key": "bob_public_key.pem"}
    POST /extract  {"stego": ..., "output": ...,
                    "delta": 20, "coeffs": 10, "auto_params": false,
                    "private_key": "bob_private_key.pem"}
    POST /inspect  {"stego": ..., "delta": 20, "coeffs": 10}
    POST /capacity {"video": ..., "delta": 20, "coeffs": 10}
    POST /steganalyze {"video": ..., "coeffs": 10, "max_frames": 4}
    GET  /healthz

All paths are SERVER-side filesystem paths: this is a localhost daemon for
pipelines/fleet tooling (bind 127.0.0.1 by default), not an internet
service — it performs no authentication and reads/writes the local disk on
request. Two guards keep web pages from driving it cross-origin even on
localhost: POSTs must carry Content-Type: application/json (a browser
cannot send that without a CORS preflight, which this server never
grants), and the Host header must name the bound address (blocks DNS
rebinding). Requests are serialized through one worker lock: one device
and one kernel library serve every request, and the host codec is the
bottleneck anyway, so concurrency belongs at the process/file level
(embed-batch --jobs), not inside the daemon.

The server resolves its device once (``make_server``: the card unless the
caller names another; with no card it raises) and hands that explicit
``torch.device`` to every pipeline call; no handler selects a current
device. A CUDA error is a RuntimeError and reaches the client as a 500
with its message. ``serve`` builds or loads the kernel library and
initialises the card before it binds, so the first request does not pay
the build.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from stegotpu_torch.config import StegoConfig
from stegotpu_torch.device import resolve_device
from stegotpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_MAX_BODY = 1 << 20  # JSON control messages only; files travel by path


class _MissingField(Exception):
    """A required request field is absent (client error, -> 400)."""


def _require(req: dict, key: str):
    """Fetch a required field; absence is a CLIENT error. (A bare
    req[key] would raise KeyError, indistinguishable from a KeyError bug
    deep inside a pipeline call — which must surface as a 500, not be
    misreported as 'missing required field'.)"""
    try:
        return req[key]
    except KeyError:
        raise _MissingField(key) from None


def _config_from(req: dict) -> StegoConfig:
    return StegoConfig(
        delta=int(req.get("delta", 20)),
        num_ac_coeffs=int(req.get("coeffs", 10)),
        kernel=req.get("kernel", "auto"),
        codec=req.get("codec", "FFV1"),
        verified_embed=bool(req.get("verified", False)),
        allow_residual=bool(req.get("allow_residual", False)),
        qim_precision=req.get("precision", "wire"),
    )


def _do_embed(req: dict, device) -> dict:
    from stegotpu_torch import crypto
    from stegotpu_torch.pipeline import embed_image_in_video

    pub = crypto.serialize_public_compressed(
        crypto.load_public_pem(req.get("public_key", "bob_public_key.pem")))
    res = embed_image_in_video(
        _require(req, "cover"), _require(req, "secret"),
        _require(req, "output"), pub, _config_from(req),
        batch_frames=int(req.get("batch", 8)), device=device,
    )
    out = {
        "success": res.success,
        "output_path": res.output_path,
        "payload_bits": res.total_payload_bits,
        "bits_embedded": res.bits_embedded,
        "frames_used": res.frames_used,
        "residual_bits": res.residual_bits,
    }
    if res.error:
        out["error"] = res.error
    psnr = res.first_frame_psnr
    if psnr is not None:
        out["first_frame_psnr_db"] = round(psnr, 2)
    return out


def _do_extract(req: dict, device) -> dict:
    from stegotpu_torch import crypto
    from stegotpu_torch.pipeline import extract_image_from_video

    priv = crypto.load_private_pem(
        req.get("private_key", "bob_private_key.pem"))
    cfg = _config_from(req)
    res = extract_image_from_video(
        _require(req, "stego"), priv, cfg, req.get("output"),
        batch_frames=int(req.get("batch", 8)), device=device,
    )
    recovered = None
    recovery_note = None
    if not res.success and bool(req.get("auto_params", False)):
        # RECOVERY MODE (mirrors `extract --auto-params`):
        # steganalysis.recover_params is the shared core
        from stegotpu_torch.steganalysis import recover_params

        new_cfg, recovery_note = recover_params(_require(req, "stego"), cfg,
                                                device=device)
        if new_cfg is not None:
            cfg = new_cfg
            res = extract_image_from_video(
                _require(req, "stego"), priv, cfg, req.get("output"),
                batch_frames=int(req.get("batch", 8)), device=device,
            )
            recovered = {"delta": cfg.delta, "coeffs": cfg.num_ac_coeffs}
    out = {
        "success": res.success,
        "hash_ok": res.hash_ok,
        "output_path": res.output_path,
        "frames_read": res.frames_read,
    }
    if recovered is not None:
        out["recovered_params"] = recovered
    elif recovery_note is not None:
        out["recovery_failed"] = recovery_note
    if res.error:
        out["error"] = res.error
    if res.success and not res.is_raw_data:
        out["secret_width"] = res.parts.secret_width
        out["secret_height"] = res.parts.secret_height
    if res.success and res.is_raw_data:
        out["raw_bytes"] = len(res.data)
    return out


def _do_inspect(req: dict, device) -> dict:
    from stegotpu_torch.pipeline import inspect_stego_header

    try:
        d = inspect_stego_header(_require(req, "stego"), _config_from(req),
                                 device=device)
    except ValueError as e:
        return {"success": False, "error": str(e)}
    return {"success": True, **d}


def _do_capacity(req: dict, device) -> dict:
    from stegotpu_torch.evaluation import capacity_report

    r = capacity_report(_require(req, "video"), _config_from(req))
    return {"success": True, "width": r.width, "height": r.height,
            "frames": r.frames, "qim_bits_per_frame": r.qim_bits_per_frame,
            "total_qim_bits": r.total_qim_bits,
            "max_secret_pixels": r.max_secret_pixels}


def _do_steganalyze(req: dict, device) -> dict:
    from stegotpu_torch.steganalysis import (analyze_frames, estimate_num_ac,
                                             read_gray_frames)

    gray = read_gray_frames(_require(req, "video"), int(req.get("max_frames", 4)))
    rep = analyze_frames(gray, num_ac=int(req.get("coeffs", 10)),
                         device=device)
    out = {"success": True, "verdict": rep.verdict, "detected": rep.detected,
           "detection_ratio": round(rep.detection_ratio, 3)}
    if rep.detected:
        out["estimated_delta"] = int(rep.best_delta)
        out["estimated_num_ac"] = int(estimate_num_ac(gray, rep.best_delta,
                                                      device=device))
    return out


_ROUTES = {"/embed": _do_embed, "/extract": _do_extract,
           "/inspect": _do_inspect, "/capacity": _do_capacity,
           "/steganalyze": _do_steganalyze}


class _Handler(BaseHTTPRequestHandler):
    server_version = "stegotpu_torch"
    # socket timeout: a client that sends headers claiming a body and then
    # stalls must not pin a handler thread forever (rfile reads honor this
    # via the connection timeout socketserver applies from this attribute)
    timeout = 120
    _lock = threading.Lock()  # one pipeline at a time (see module docstring)

    def log_message(self, fmt, *args):  # route through our logger
        log.debug("http: " + fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        # same anti-rebinding gate as POST: even read-only endpoints should
        # not be fingerprintable by a rebound page
        if not self._host_allowed():
            self._reply(403, {"error": "forbidden Host header"})
            return
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "endpoints": sorted(_ROUTES)})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _host_allowed(self) -> bool:
        # bracket-aware port strip: '[::1]:8752' and bare '[::1]' both
        # normalize to '::1' (a naive rsplit(':') mangles bracketed IPv6)
        from urllib.parse import urlsplit

        try:
            host = urlsplit("//" + (self.headers.get("Host") or "")).hostname
        except ValueError:
            return False
        allowed = getattr(self.server, "allowed_hosts",
                          {"127.0.0.1", "localhost", "::1"})
        if allowed is None:  # wildcard bind: check disabled (make_server)
            return True
        return host in allowed

    def do_POST(self):
        # anti-DNS-rebinding: the Host header must name the bound address
        if not self._host_allowed():
            self._reply(403, {"error": "forbidden Host header"})
            return
        # browsers cannot send application/json cross-origin without a CORS
        # preflight (never granted here) — this blocks malicious web pages
        # from driving the daemon via "simple" no-preflight requests
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype != "application/json":
            self._reply(415, {"error": "Content-Type must be application/json"})
            return
        handler = _ROUTES.get(self.path)
        if handler is None:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > _MAX_BODY:
                self._reply(413, {"error": "request body too large"})
                return
            if length < 0:
                # read(-1) would block until the CLIENT closes — with a
                # lying peer that pins this handler thread forever
                self._reply(400, {"error": "invalid Content-Length"})
                return
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            with self._lock:
                out = handler(req, self.server.device)
            self._reply(200 if out.get("success", True) else 422, out)
        except _MissingField as e:
            self._reply(400, {"error": f"missing required field: '{e}'"})
        except (OSError, ValueError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # surface, don't kill the daemon thread
            # a CUDA error (RuntimeError) lands here: a 500 with its
            # message, never a 400 and never a retry on the plain version
            log.exception("unhandled server error")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(host: str = "127.0.0.1", port: int = 0,
                device=None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; port 0 picks a free port.

    device: the torch device of every request's kernels, resolved once
    here (None: the card; raises where there is none) and kept as the
    server's ``device``. Builds nothing: ``serve`` warms the card."""
    dev = resolve_device(device)
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.device = dev
    # urlsplit().hostname (the comparison side) is lowercase and unbracketed
    srv.allowed_hosts = {host.strip("[]").lower(), "127.0.0.1", "localhost",
                         "::1"}
    # The Host allowlist exists to stop DNS-rebinding against the default
    # LOOPBACK daemon. A wildcard bind means the operator deliberately
    # exposed the service on every interface — clients then send whatever
    # address they reached it by (e.g. 192.168.1.5:8752), which a literal
    # allowlist of the bind string would 403. Disable the check there; the
    # rebinding defense is only meaningful for loopback binds anyway.
    if host.strip("[]") in ("0.0.0.0", "::", ""):
        srv.allowed_hosts = None  # _host_allowed: any Host accepted
    return srv


def _warm(device) -> None:
    """On a CUDA device: build or load the kernel library and create the
    device's context, so that no request pays either (the build alone
    takes a minute or more, longer than a client's timeout)."""
    import torch

    if device.type != "cuda":
        return
    from stegotpu_torch.ops import _build

    _build.build()
    _build.load_library()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)


def serve(host: str = "127.0.0.1", port: int = 8752, device=None) -> None:
    """Blocking entry point (the CLI's `serve` subcommand)."""
    dev = resolve_device(device)
    _warm(dev)
    srv = make_server(host, port, dev)
    log.info("serving on http://%s:%d (device %s; endpoints: %s)", host,
             srv.server_address[1], dev,
             ", ".join(sorted(_ROUTES)) + ", /healthz")
    print(f"stegotpu_torch serving on http://{host}:{srv.server_address[1]} "
          f"(device {dev})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
