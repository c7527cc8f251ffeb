"""Command-line interface of the port: embed / extract (+ batch, dist and
segment variants) / genkey / evaluate / capacity / inspect / steganalyze /
fixtures / selftest / serve / concat / bench.

Counterpart of ``stegotpu/cli.py``, with the same subcommands, flags,
messages and exit codes, run through ``stegotpu_torch``: the QIM kernels
on the card (the CUDA kernels of ``csrc/``), crypto, framing and codecs on
the host. ``python -m stegotpu_torch.cli`` or ``stegotpu-torch``.

The global ``--device`` takes the place of the JAX CLI's ``--platform``:
the entry points' ``device`` argument, the card by default and ``cpu`` to
run the kernels' plain versions (the tests do). The global
``--host-devices N`` gives a ``--mesh`` N CPU devices with ``--device cpu``
(on the card, a mesh spans the CUDA cards). ``dist-embed`` and
``dist-extract`` form a torch.distributed (Gloo) group from
``--coordinator``, ``--num-processes`` and ``--process-id``. ``selftest``
re-proves the kernels' exactness on the card
(``ops/exactness.quick_exactness_check``) where the JAX CLI does so on a
TPU. ``serve`` runs the JSON-over-HTTP daemon (``server.py``) on the
global ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from stegotpu_torch.config import StegoConfig

def _config_from_args(args) -> StegoConfig:
    return StegoConfig(delta=args.delta, num_ac_coeffs=args.coeffs,
                       kernel=getattr(args, "kernel", "auto"),
                       verified_embed=getattr(args, "verified", False),
                       allow_residual=getattr(args, "allow_residual", False),
                       codec=getattr(args, "codec", "FFV1"),
                       qim_precision=getattr(args, "precision", "wire"))


def _procs_arg(v: str):
    """--procs value: a worker count, or 'auto' = min(host cores, segments)
    (parallel.local_procs.resolve_procs)."""
    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--procs takes an integer or 'auto', got {v!r}") from None


def _procs_requested(args) -> tuple:
    """(procs, mode, active): the --procs/--procs-mode pair; active when
    a parallel run was requested ('auto' or N > 1)."""
    procs = getattr(args, "procs", 1) or 1
    mode = getattr(args, "procs_mode", "thread")
    return procs, mode, procs == "auto" or int(procs) > 1


def _add_qim_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--delta", type=int, default=20,
                   help="QIM quantization step (default 20)")
    p.add_argument("--coeffs", type=int, default=10,
                   help="AC coefficients per 8x8 block, 1..63 (default 10)")
    p.add_argument("--kernel", choices=["auto", "xla", "pallas"], default="auto",
                   help="device kernel: auto/pallas run the CUDA stripe "
                        "kernels, xla the Kronecker-matmul oracle (default "
                        "auto)")
    p.add_argument("--precision", choices=["wire", "fast"], default="wire",
                   help="kept for configs shared with the JAX package: "
                        "both names run the f32 wire arithmetic here")


def _add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default=None, metavar="data=N,space=M",
                   help="scatter each batch over a device mesh: frames on "
                        "the 'data' axis, 8-px block rows on 'space' "
                        "(e.g. data=4,space=2; needs N*M devices: the CUDA "
                        "cards, or --device cpu --host-devices N)")


def _mesh_from_args(args):
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from stegotpu_torch.parallel.mesh import local_devices, product_mesh

    return product_mesh(spec, devices=local_devices(args.device,
                                                    args.host_devices))


def _device_and_mesh(args):
    """(device, mesh) for a pipeline call: a --mesh names its own devices,
    so the pipeline then takes no device."""
    mesh = _mesh_from_args(args)
    return (args.device if mesh is None else None), mesh


def _add_procs_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--procs", type=_procs_arg, default=1, metavar="N|auto",
                   help="run N segment-parallel worker pipelines on this "
                        "host (one seal, exact-seek segments; embed "
                        "stitches by packet concat, pixel-identical to "
                        "--procs 1, and needs the native layer); 'auto' = "
                        "min(cores, segments)")
    p.add_argument("--procs-mode", choices=["thread", "spawn"],
                   default="thread",
                   help="worker kind: 'thread' (default; the codec and "
                        "kernel stages release the GIL; the caller's "
                        "device) or 'spawn' OS processes that compute the "
                        "plain versions on the CPU and never open the card "
                        "(on the card their stego may differ from the CUDA "
                        "kernels' by ±1 pixel level at f32 rounding "
                        "boundaries, same wire bits)")


def _add_codec_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--codec", choices=["FFV1", "HFYU", "RGBA"], default="FFV1",
                   help="lossless stego container codec: FFV1 (reference "
                        "parity, default), HFYU (HuffYUV, ~5x faster encode), "
                        "RGBA (raw, fastest, largest files); all are "
                        "pixel-exact and extraction auto-detects")


def cmd_genkey(args) -> int:
    from stegotpu_torch import crypto

    priv_path = Path(args.private)
    pub_path = Path(args.public)
    if (priv_path.exists() or pub_path.exists()) and not args.force:
        print(f"key files exist ({priv_path}, {pub_path}); use --force to overwrite",
              file=sys.stderr)
        return 1
    passphrase = None
    if args.passphrase:
        # never on argv (leaks via ps/shell history): env var, else prompt
        import os

        secret = os.environ.get("STEGOTPU_KEY_PASSPHRASE")
        if not secret:
            import getpass

            secret = getpass.getpass("key passphrase: ")
            if secret != getpass.getpass("repeat passphrase: "):
                print("passphrases do not match", file=sys.stderr)
                return 1
        if not secret:
            print("empty passphrase; use plain genkey for an unencrypted "
                  "key", file=sys.stderr)
            return 1
        passphrase = secret.encode()
    if args.force and (priv_path.exists() or pub_path.exists()):
        # never destroy the old keypair before the new one exists: generate
        # into temp files and swap in atomically
        import os

        tmp_priv = priv_path.with_suffix(priv_path.suffix + ".new")
        tmp_pub = pub_path.with_suffix(pub_path.suffix + ".new")
        tmp_priv.unlink(missing_ok=True)
        tmp_pub.unlink(missing_ok=True)
        crypto.setup_receiver_keys(tmp_priv, tmp_pub, passphrase)
        os.replace(tmp_priv, priv_path)
        os.replace(tmp_pub, pub_path)
    else:
        crypto.setup_receiver_keys(priv_path, pub_path, passphrase)
    kind = "encrypted PKCS8" if passphrase else "SECP256R1"
    print(f"wrote {priv_path} and {pub_path} ({kind})")
    return 0


def _make_timer(args):
    if not getattr(args, "timing", False):
        return None
    from stegotpu_torch.utils.profiling import StageTimer

    return StageTimer()


def _report_timer(timer) -> None:
    if timer is not None and timer.totals:
        print("--- stage timing ---", file=sys.stderr)
        print(timer.report(), file=sys.stderr)


def _public_key(path) -> bytes:
    from stegotpu_torch import crypto

    return crypto.serialize_public_compressed(crypto.load_public_pem(path))


def _sealed_state(args, pub: bytes):
    """--payload-state: the sealed payload bits persisted across segment
    runs (loaded when the file exists, sealed and saved otherwise), or an
    int exit code when the state belongs to another secret."""
    import numpy as np

    from stegotpu_torch import image as image_codec
    from stegotpu_torch import payload as payload_mod
    from stegotpu_torch.bitstream import bits_to_bytes

    state = args.payload_state
    # np.save appends .npy when missing — normalize so the resume run's
    # existence check looks at the file the first run actually wrote
    state_npy = state if str(state).endswith(".npy") else f"{state}.npy"
    w_px, h_px, img_bits = image_codec.image_to_bits(args.secret)
    if Path(state_npy).exists():
        sealed = np.load(state_npy)
        # the state is authoritative on resume: guard against a stale state
        # from a DIFFERENT secret — dims + ciphertext length parse without keys
        hdr, ct_len, _pos = payload_mod.parse_header_bits(
            np.asarray(sealed, dtype=np.uint8),
            _config_from_args(args).dims_bits)
        if ((hdr.secret_width, hdr.secret_height) != (w_px, h_px)
                or ct_len != len(bits_to_bytes(img_bits))):
            print(f"error: payload state '{state_npy}' was sealed from "
                  f"a different secret ({hdr.secret_width}x"
                  f"{hdr.secret_height}, {ct_len} ciphertext bytes) "
                  f"than '{args.secret}' ({w_px}x{h_px}) — delete the "
                  "state file to reseal", file=sys.stderr)
            return 1
        print(f"loaded sealed payload from '{state_npy}' "
              "(resume: embedding the state's crypto stream)")
        return sealed
    sealed, _ = payload_mod.seal_payload(
        bits_to_bytes(img_bits), w_px, h_px, pub,
        _config_from_args(args).dims_bits)
    np.save(state_npy, np.asarray(sealed, dtype=np.uint8))
    print(f"sealed payload saved to '{state_npy}' "
          "(contains the ciphertext — protect like the stego)")
    return sealed


def cmd_embed(args) -> int:
    from stegotpu_torch.pipeline import embed_image_in_video

    if getattr(args, "auto_fixtures", False):
        # reference parity (opt-in): missing inputs are generated
        # (config_and_setup.py:219-238, its README.md:134-137)
        from stegotpu_torch import fixtures

        if not Path(args.cover).exists():
            fixtures.make_cover_video(args.cover, 640, 480, frames=120,
                                      fps=24.0, kind="noise")
            print(f"auto-fixtures: generated dummy cover '{args.cover}' "
                  "(640x480, 120 frames, noise)")
        if not Path(args.secret).exists():
            fixtures.make_secret_image(args.secret, 32, 32, kind="gray")
            print(f"auto-fixtures: generated dummy secret '{args.secret}' "
                  "(32x32 light gray)")
    pub = _public_key(args.public_key)
    timer = _make_timer(args)

    frame_range = None
    if getattr(args, "frame_range", None):
        lo_s, _, hi_s = args.frame_range.partition(":")
        frame_range = (int(lo_s or 0), int(hi_s) if hi_s else None)
    sealed = None
    if frame_range is not None and frame_range[0] > 0 and not args.payload_state:
        # a mid-video segment sealed with FRESH crypto randomness can never
        # decode against other runs' segments
        print("error: --frame-range with LO > 0 requires --payload-state: "
              "each invocation seals fresh crypto randomness, so this "
              "segment's bits would disagree with segment 0's run and the "
              "concat-stitched video could never decrypt", file=sys.stderr)
        return 1
    if args.payload_state:
        sealed = _sealed_state(args, pub)
        if isinstance(sealed, int):
            return sealed

    procs, procs_mode, procs_active = _procs_requested(args)
    if procs_active and procs == "auto" and (
            frame_range is not None or getattr(args, "mesh", None)):
        # 'auto' means "pick the best mode for this invocation" — with
        # --frame-range/--mesh the segment cutter can't run, and the plain
        # pipeline handles both, so auto resolves to it (an explicit
        # --procs N>1 still conflicts loudly below)
        print("note: --procs auto defers to the plain pipeline "
              "(--frame-range/--mesh handle their own partitioning)",
              file=sys.stderr)
        procs_active = False
    if procs_active:
        if frame_range is not None:
            print("error: --procs cuts its own segments; it cannot combine "
                  "with --frame-range", file=sys.stderr)
            return 1
        if getattr(args, "mesh", None):
            print("error: --procs (host-parallel segments) and --mesh "
                  "(device mesh) cannot combine; use dist-embed for the "
                  "full hierarchy", file=sys.stderr)
            return 1
        if timer is not None:
            print("note: --timing is per-pipeline; stage breakdowns are "
                  "not collected across --procs workers", file=sys.stderr)
            timer = None
        from stegotpu_torch.parallel.local_procs import parallel_embed

        res = parallel_embed(
            args.cover, args.secret, args.output, pub,
            _config_from_args(args), batch_frames=args.batch, procs=procs,
            sealed_bits=sealed, mode=procs_mode, device=args.device,
        )
    else:
        device, mesh = _device_and_mesh(args)
        res = embed_image_in_video(
            args.cover, args.secret, args.output, pub,
            _config_from_args(args), batch_frames=args.batch, timer=timer,
            mesh=mesh, frame_range=frame_range, sealed_bits=sealed,
            device=device,
        )
    _report_timer(timer)
    if not res.success:
        if res.residual_bits:
            print(f"EMBED FAILED: {res.residual_bits} unrepairable payload "
                  f"bits after verified repair (saturated cover) — "
                  f"--allow-residual emits the file anyway", file=sys.stderr)
        else:
            reason = res.error or (
                f"{res.bits_embedded}/{res.total_payload_bits} bits "
                "embedded before the video ended")
            print(f"EMBED FAILED: {reason}", file=sys.stderr)
        return 1
    print(f"embedded {res.total_payload_bits} bits into '{res.output_path}' "
          f"({res.frames_used} frames)")
    psnr = res.first_frame_psnr
    if psnr is not None:
        print(f"first-frame PSNR (original vs stego gray): {psnr:.2f} dB")
    return 0


def cmd_extract(args) -> int:
    from stegotpu_torch import crypto
    from stegotpu_torch.pipeline import extract_image_from_video

    priv = crypto.load_private_pem(args.private_key)
    timer = _make_timer(args)
    cfg = _config_from_args(args)
    procs, procs_mode, procs_active = _procs_requested(args)
    if procs_active and getattr(args, "mesh", None):
        if procs == "auto":
            # auto picks the best mode for the invocation: --mesh shards
            # on the devices, the plain pipeline drives it (see cmd_embed)
            print("note: --procs auto defers to the plain pipeline "
                  "(--mesh handles its own partitioning)", file=sys.stderr)
            procs_active = False
        else:
            print("error: --procs (host-parallel segments) and --mesh "
                  "(device mesh) cannot combine; use dist-extract for the "
                  "full hierarchy", file=sys.stderr)
            return 1
    device, mesh = (args.device, None) if procs_active else \
        _device_and_mesh(args)

    def run(run_cfg):
        if procs_active:
            if timer is not None:
                print("note: --timing is per-pipeline; stage breakdowns "
                      "are not collected across --procs workers",
                      file=sys.stderr)
            from stegotpu_torch.parallel.local_procs import parallel_extract

            return parallel_extract(args.stego, priv, run_cfg, args.output,
                                    batch_frames=args.batch, procs=procs,
                                    mode=procs_mode, device=device)
        return extract_image_from_video(args.stego, priv, run_cfg, args.output,
                                        batch_frames=args.batch, timer=timer,
                                        mesh=mesh, device=device)

    res = run(cfg)
    if not res.success and getattr(args, "auto_params", False):
        # RECOVERY MODE: the QIM lattice leaks delta and num_ac to anyone
        # (steganalysis.recover_params), so when the supplied/default
        # parameters fail, recover them from the stego itself and retry once
        from stegotpu_torch.steganalysis import recover_params

        print(f"extract failed with delta={cfg.delta}, "
              f"coeffs={cfg.num_ac_coeffs} ({res.error}); running "
              "steganalysis parameter recovery...", file=sys.stderr)
        new_cfg, msg = recover_params(args.stego, cfg, device=args.device)
        if new_cfg is not None:
            print(f"RECOVERY: {msg} — retrying", file=sys.stderr)
            cfg = new_cfg
            res = run(cfg)
        else:
            print(f"RECOVERY FAILED: {msg}", file=sys.stderr)
    _report_timer(timer)
    if not res.success:
        print(f"EXTRACT FAILED: {res.error}", file=sys.stderr)
        return 1
    if cfg.delta != args.delta or cfg.num_ac_coeffs != args.coeffs:
        print(f"(recovered parameters: delta={cfg.delta}, "
              f"coeffs={cfg.num_ac_coeffs})")
    if res.is_raw_data:
        print(f"extracted {len(res.data)} bytes of raw data to '{res.output_path}'")
    else:
        print(f"extracted {res.parts.secret_width}x{res.parts.secret_height} "
              f"image to '{res.output_path}'")
    print("SHA3-256 integrity:", "OK" if res.hash_ok else "MISMATCH (payload may be corrupt)")
    return 0


def _run_file_batch(items, out_dir: Path, jobs_flag: int, one, report):
    """Shared scaffolding of embed-batch / extract-batch: duplicate-stem
    guard, --jobs auto-pick (affinity-aware), thread-pool fan-out with
    reports in INPUT order regardless of completion order.

    one(item) -> result (OSError/ValueError become per-item failures);
    report(item, res) -> True if the item succeeded (prints its own line).
    Returns (failures, elapsed_s); failures < 0 means the dupe guard fired.
    """
    import time
    from concurrent.futures import ThreadPoolExecutor

    from stegotpu_torch.video import effective_cpu_count

    out_dir.mkdir(parents=True, exist_ok=True)
    stems = [Path(i).stem for i in items]
    dupes = {s for s in stems if stems.count(s) > 1}
    if dupes:
        print("error: inputs with the same filename would overwrite each "
              f"other's output: {sorted(dupes)} — rename or run separately",
              file=sys.stderr)
        return -1, 0.0
    jobs = jobs_flag if jobs_flag else (2 if effective_cpu_count() > 1 else 1)
    failures = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        futures = [(i, pool.submit(one, i)) for i in items]
        for item, fut in futures:
            try:
                res = fut.result()
            except (OSError, ValueError) as e:
                print(f"{item}: FAILED ({e})", file=sys.stderr)
                failures += 1
                continue
            if not report(item, res):
                failures += 1
    return failures, time.perf_counter() - t0


def cmd_embed_batch(args) -> int:
    """Embed one secret into MANY covers in one process; with --jobs > 1
    files overlap on threads (one file's encode drains while the next
    decodes)."""
    from stegotpu_torch.pipeline import embed_image_in_video

    pub = _public_key(args.public_key)
    cfg = _config_from_args(args)
    out_dir = Path(args.out_dir)
    frames_total = 0

    def one(cover):
        out = out_dir / (Path(cover).stem + ".avi")
        return embed_image_in_video(cover, args.secret, out, pub, cfg,
                                    batch_frames=args.batch,
                                    device=args.device)

    def report(cover, res) -> bool:
        nonlocal frames_total
        if not res.success:
            print(f"{cover}: FAILED ({res.bits_embedded}/"
                  f"{res.total_payload_bits} bits before video ended)",
                  file=sys.stderr)
            return False
        frames_total += res.frames_used
        print(f"{cover}: -> {res.output_path} ({res.total_payload_bits} "
              f"bits, {res.frames_used} frames)")
        return True

    failures, dt = _run_file_batch(args.covers, out_dir, args.jobs, one, report)
    if failures < 0:
        return 1
    n_ok = len(args.covers) - failures
    print(f"batch done: {n_ok}/{len(args.covers)} covers embedded, "
          f"{frames_total} frames in {dt:.2f}s")
    return 1 if failures else 0


def cmd_extract_batch(args) -> int:
    """Extract from MANY stego videos in one process (embed-batch's
    inverse). Raw-data payloads write <stem>.bin, images <stem>.png."""
    from stegotpu_torch import crypto
    from stegotpu_torch.image import save_image_gray
    from stegotpu_torch.pipeline import extract_image_from_video

    priv = crypto.load_private_pem(args.private_key)
    cfg = _config_from_args(args)
    out_dir = Path(args.out_dir)

    def one(stego):
        # outputs are written in report(): the extension depends on the
        # parsed payload kind
        return extract_image_from_video(stego, priv, cfg,
                                        batch_frames=args.batch,
                                        device=args.device)

    def report(stego, res) -> bool:
        if not res.success:
            print(f"{stego}: FAILED ({res.error})", file=sys.stderr)
            return False
        if res.is_raw_data:
            out = out_dir / (Path(stego).stem + ".bin")
            out.write_bytes(res.data)
            print(f"{stego}: -> {out} ({len(res.data)} bytes raw"
                  f"{'' if res.hash_ok else ', SHA3 MISMATCH'})")
        else:
            out = out_dir / (Path(stego).stem + ".png")
            save_image_gray(res.pixels, out)
            print(f"{stego}: -> {out} ({res.parts.secret_width}x"
                  f"{res.parts.secret_height}"
                  f"{'' if res.hash_ok else ', SHA3 MISMATCH'})")
        return res.hash_ok

    failures, dt = _run_file_batch(args.stegos, out_dir, args.jobs, one, report)
    if failures < 0:
        return 1
    n_ok = len(args.stegos) - failures
    print(f"batch done: {n_ok}/{len(args.stegos)} extracted in {dt:.2f}s")
    return 1 if failures else 0


def _dist_init(args) -> int:
    """Join the torch.distributed group; returns this process's rank."""
    from stegotpu_torch.parallel.distributed import initialize, process_index

    initialize(args.coordinator, args.num_processes, args.process_id)
    return process_index()


def cmd_dist_embed(args) -> int:
    """One process of a cooperative multi-process embed (run in each)."""
    import numpy as np
    import torch.distributed as dist

    from stegotpu_torch.parallel.dist_pipeline import distributed_embed

    _dist_init(args)
    try:
        pub = _public_key(args.public_key)
        rng = (np.random.default_rng(args.seed) if args.seed is not None
               else None)
        # the mesh spec resolves INSIDE distributed_embed so a process whose
        # devices can't satisfy it still joins the preflight collective (an
        # early local exit here would hang every peer)
        res = distributed_embed(args.cover, args.secret, args.output, pub,
                                _config_from_args(args),
                                batch_frames=args.batch, rng=rng,
                                mesh_spec=args.mesh, device=args.device,
                                host_devices=args.host_devices)
    finally:
        dist.destroy_process_group()
    if res is None:  # non-zero rank: its segment status was logged
        return 0
    if not res.success:
        reason = res.error or (f"{res.bits_embedded}/"
                               f"{res.total_payload_bits} bits fit in the "
                               "video")
        print(f"DIST EMBED FAILED: {reason}", file=sys.stderr)
        return 1
    print(f"embedded {res.total_payload_bits} bits into '{res.output_path}' "
          f"({res.frames_used} frames, {args.num_processes} hosts)")
    psnr = res.first_frame_psnr
    if psnr is not None:
        print(f"first-frame PSNR (original vs stego gray): {psnr:.2f} dB")
    return 0


def cmd_dist_extract(args) -> int:
    """One process of a cooperative multi-process extract."""
    import torch.distributed as dist

    from stegotpu_torch import crypto
    from stegotpu_torch.parallel.dist_pipeline import distributed_extract

    rank = _dist_init(args)
    try:
        priv = crypto.load_private_pem(args.private_key)
        res = distributed_extract(args.stego, priv, _config_from_args(args),
                                  args.output, batch_frames=args.batch,
                                  mesh_spec=args.mesh, device=args.device,
                                  host_devices=args.host_devices)
    finally:
        dist.destroy_process_group()
    if not res.success:
        print(f"DIST EXTRACT FAILED: {res.error}", file=sys.stderr)
        return 1
    if rank == 0:
        if res.is_raw_data:
            print(f"extracted {len(res.data)} bytes of raw data to "
                  f"'{res.output_path}'")
        else:
            print(f"extracted {res.parts.secret_width}x"
                  f"{res.parts.secret_height} image to '{res.output_path}'")
        print("SHA3-256 integrity:",
              "OK" if res.hash_ok else "MISMATCH (payload may be corrupt)")
    return 0


def cmd_embed_data(args) -> int:
    from stegotpu_torch.pipeline import embed_data_in_video

    data = Path(args.data_file).read_bytes()
    pub = _public_key(args.public_key)
    procs, procs_mode, procs_active = _procs_requested(args)
    if procs_active:
        from stegotpu_torch.parallel.local_procs import parallel_embed_data

        res = parallel_embed_data(
            args.cover, data, args.output, pub, _config_from_args(args),
            batch_frames=args.batch, procs=procs, mode=procs_mode,
            device=args.device,
        )
    else:
        res = embed_data_in_video(args.cover, data, args.output, pub,
                                  _config_from_args(args),
                                  batch_frames=args.batch, device=args.device)
    if not res.success:
        reason = getattr(res, "error", None)
        if reason:
            print(f"EMBED-DATA FAILED: {reason}", file=sys.stderr)
            return 1
        print(f"EMBED-DATA FAILED: {res.bits_embedded}/{res.total_payload_bits} "
              "bits embedded before the video ended", file=sys.stderr)
        return 1
    print(f"embedded {len(data)} bytes ({res.total_payload_bits} payload bits) "
          f"into '{res.output_path}'")
    return 0


def cmd_evaluate(args) -> int:
    from stegotpu_torch.evaluation import (compare_videos,
                                           evaluate_stego_result,
                                           measure_crypto_timings,
                                           security_summary)

    ev = evaluate_stego_result(
        args.original, args.stego, args.secret, args.extracted,
        dump_frames_dir=args.dump_frames,
    )
    if ev.video:
        print(f"stego video (first frame): PSNR {ev.video.psnr:.2f} dB, "
              f"SSIM {ev.video.ssim:.4f} -> {ev.video.verdict}")
    if args.all_frames:
        vc = compare_videos(args.original, args.stego, max_frames=args.max_frames,
                            device=args.device)
        print(f"stego video ({vc.frames} frames): mean PSNR {vc.mean_psnr:.2f} dB "
              f"(min {vc.min_psnr:.2f}), mean SSIM {vc.mean_ssim:.4f} -> {vc.verdict}")
    if ev.image:
        print(f"extracted image: PSNR {ev.image.psnr:.2f} dB, "
              f"SSIM {ev.image.ssim:.4f} -> {ev.image.verdict}")
    if args.crypto_timings:
        t = measure_crypto_timings()
        print(f"crypto (per op, {t.payload_bytes}B payload): "
              f"keygen {t.keygen_ms:.2f}ms, ecdh {t.ecdh_ms:.2f}ms, "
              f"hkdf {t.hkdf_ms:.3f}ms, aes-enc {t.aes_encrypt_ms:.3f}ms, "
              f"aes-dec {t.aes_decrypt_ms:.3f}ms, sha3 {t.sha3_ms:.3f}ms")
    print("security:", json.dumps(security_summary()))
    return 0


def cmd_capacity(args) -> int:
    from stegotpu_torch.evaluation import capacity_report

    r = capacity_report(args.video, _config_from_args(args))
    if getattr(args, "json", False):
        print(json.dumps({
            "width": r.width, "height": r.height, "frames": r.frames,
            "qim_bits_per_frame": r.qim_bits_per_frame,
            "total_qim_bits": r.total_qim_bits,
            "max_secret_pixels": r.max_secret_pixels,
            "payload_header_bits": r.payload_header_bits,
            "naive_bits_per_frame": r.naive_bits_per_frame,
        }))
        return 0
    print(f"{r.width}x{r.height}, {r.frames} frames")
    print(f"QIM capacity: {r.qim_bits_per_frame} bits/frame "
          f"({r.total_qim_bits} total)")
    print(f"max gray secret: ~{r.max_secret_pixels} pixels "
          f"(header {r.payload_header_bits} bits)")
    print(f"(naive 1 bit/px figure, as the reference reports: "
          f"{r.naive_bits_per_frame} bits/frame)")
    return 0


def cmd_fixtures(args) -> int:
    from stegotpu_torch.fixtures import make_cover_video, make_secret_image

    out = Path(args.dir)
    make_secret_image(out / "secret.png", args.secret_size, args.secret_size,
                      kind="pattern")
    make_cover_video(out / "cover.mp4", args.width, args.height,
                     frames=args.frames, kind=args.kind)
    print(f"wrote {out}/secret.png and {out}/cover.mp4")
    return 0


def cmd_bench(args) -> int:
    from stegotpu_torch.benchmark import main as bench_main

    if args.device is not None and not str(args.device).startswith("cuda"):
        print(f"error: bench measures the card; --device {args.device} has "
              "no benchmark", file=sys.stderr)
        return 1
    try:
        return bench_main()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def cmd_serve(args) -> int:
    from stegotpu_torch.server import serve

    serve(args.host, args.port, args.device)
    return 0


def cmd_concat(args) -> int:
    """Stitch same-codec segments by packet stream-copy (no re-encode)."""
    from stegotpu_torch.native.videoio import (available, build_error,
                                               concat_videos)

    if not available():
        print(f"error: concat needs the native layer ({build_error()})",
              file=sys.stderr)
        return 1
    concat_videos(args.output, args.segments)
    print(f"stitched {len(args.segments)} segments into '{args.output}'")
    return 0


def cmd_inspect(args) -> int:
    """Parse a stego video's embedded header WITHOUT decrypting: the public
    payload fields (secret dims, field lengths, ciphertext size, frames
    needed), from the header bits alone."""
    from stegotpu_torch.pipeline import inspect_stego_header

    try:
        d = inspect_stego_header(args.stego, _config_from_args(args),
                                 device=args.device)
    except ValueError as e:
        print(f"header does not parse: {e}", file=sys.stderr)
        print("likely wrong --delta/--coeffs or not a stego video",
              file=sys.stderr)
        return 1
    if getattr(args, "json", False):
        print(json.dumps(d))
        return 0
    print(f"video: {d['width']}x{d['height']} @ {d['fps']:.3g} fps; "
          f"capacity {d['capacity_bits_per_frame']} bits/frame "
          f"(delta={d['delta']}, coeffs={d['num_ac_coeffs']})")
    if d["payload_type"] == "raw_data":
        print("payload type: raw data (extension mode)")
    else:
        print(f"secret image: {d['secret_width']}x{d['secret_height']} "
              "grayscale")
    print(f"ephemeral sender pubkey: {d['sender_pub_bytes']} bytes "
          f"(prefix 0x{d['sender_pub_prefix']})")
    print(f"HKDF salt: {d['hkdf_salt_bytes']} bytes; "
          f"GCM nonce: {d['nonce_bytes']} bytes; tag: {d['tag_bytes']} bytes")
    print(f"SHA3-256 digest: {d['sha3_256']}")
    print(f"ciphertext: {d['ciphertext_bytes']} bytes")
    print(f"total payload: {d['total_payload_bits']} bits across "
          f"{d['payload_frames']} frame(s)")
    return 0


def cmd_steganalyze(args) -> int:
    """Detect QIM embedding in a video and estimate its out-of-band
    parameters (delta AND num_ac), no keys needed."""
    from stegotpu_torch.steganalysis import (analyze_frames, estimate_num_ac,
                                             read_gray_frames)

    gray = read_gray_frames(args.video, args.max_frames)
    rep = analyze_frames(gray, num_ac=args.coeffs, device=args.device)
    if getattr(args, "json", False):
        out = {"verdict": rep.verdict, "detected": rep.detected,
               "detection_ratio": round(rep.detection_ratio, 3),
               "background_score": round(rep.background, 4)}
        if rep.detected:
            out["estimated_delta"] = int(rep.best_delta)
            out["lattice_score"] = round(rep.best_score, 4)
            out["estimated_num_ac"] = int(estimate_num_ac(
                gray, rep.best_delta, device=args.device))
        print(json.dumps(out))
        return 0
    print(f"verdict: {rep.verdict} "
          f"(detection ratio {rep.detection_ratio:.1f}x over background)")
    if rep.detected:
        n_est = estimate_num_ac(gray, rep.best_delta, device=args.device)
        print(f"estimated delta: {rep.best_delta} "
              f"(lattice score {rep.best_score:.3f} vs background "
              f"{rep.background:.3f})")
        print(f"estimated num_ac_coeffs: {n_est} "
              "(slots 1..N saturate the lattice)")
        print("note: QIM lattice structure is inherently detectable — "
              "confidentiality rests on the AES-GCM/ECDH layer, not on "
              "the embedding's invisibility. With these two recovered "
              "parameters, `inspect` reads the public header fields "
              "without any key material.")
    return 0


def cmd_selftest(args) -> int:
    """End-to-end smoke: fixtures -> genkey -> embed -> extract -> compare,
    then, on the card, the kernels' exactness check.

    One-command equivalent of the reference's per-module __main__ smoke
    drivers (reference: embed_process.py:155-217, extract_process.py:219-276,
    config_and_setup.py:241-276) with their auto-generated dummy inputs.
    """
    import tempfile

    import numpy as np

    from stegotpu_torch import crypto
    from stegotpu_torch.device import resolve_device
    from stegotpu_torch.fixtures import make_cover_video, make_secret_image
    from stegotpu_torch.image import load_image_gray
    from stegotpu_torch.pipeline import (embed_image_in_video,
                                         extract_image_from_video)

    mesh = _mesh_from_args(args)
    device = mesh.first_device if mesh is not None \
        else resolve_device(args.device)
    run_device = None if mesh is not None else device
    d = Path(args.dir or tempfile.mkdtemp(prefix="stegotpu-torch-selftest-"))
    d.mkdir(parents=True, exist_ok=True)
    print(f"selftest dir: {d} (device {device})")
    if mesh is not None:
        print(f"mesh: data={mesh.shape['data']} x space="
              f"{mesh.shape['space']} ({mesh.devices.size} devices, "
              f"{device.type})")
    make_secret_image(d / "secret.png", 32, 32, kind="pattern")
    make_cover_video(d / "cover.mp4", 640, 480, frames=24, kind="moving")
    priv, pub_c = crypto.setup_receiver_keys(d / "priv.pem", d / "pub.pem")
    cfg = _config_from_args(args)
    res = embed_image_in_video(d / "cover.mp4", d / "secret.png", d / "stego",
                               pub_c, cfg, mesh=mesh, device=run_device)
    if not res.success:
        print("SELFTEST FAILED: embed did not complete", file=sys.stderr)
        return 1
    print(f"embedded {res.total_payload_bits} bits, "
          f"first-frame PSNR {res.first_frame_psnr:.2f} dB")
    ext = extract_image_from_video(res.output_path, priv, cfg,
                                   d / "extracted.png", mesh=mesh,
                                   device=run_device)
    if not ext.success:
        print(f"SELFTEST FAILED: extract: {ext.error}", file=sys.stderr)
        return 1
    identical = np.array_equal(ext.pixels, load_image_gray(d / "secret.png"))
    print("SHA3 integrity:", "OK" if ext.hash_ok else "MISMATCH")
    print("pixel identity:", "IDENTICAL" if identical else "DIFFERENT")
    if not (ext.hash_ok and identical):
        print("SELFTEST FAILED", file=sys.stderr)
        return 1
    if device.type == "cuda":
        # on the card, re-prove the CUDA kernels' exactness against the f32
        # oracle (gpucheck.py is the full sweep; this is one configuration)
        from stegotpu_torch.ops.exactness import quick_exactness_check

        print("CUDA device: kernel exactness check...")
        row = quick_exactness_check(device=device)
        print("kernel exactness:", "OK" if row["ok"] else "VIOLATION",
              f"(stego extract mismatches: {row['extract_mismatch_stego']}, "
              "non-boundary cover: "
              f"{row['extract_mismatch_cover_nonboundary']})")
        if not row["ok"]:
            print("SELFTEST FAILED: a CUDA kernel does not match the f32 "
                  "oracle", file=sys.stderr)
            return 1
    print("SELFTEST PASSED")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from stegotpu_torch import __version__

    p = argparse.ArgumentParser(
        prog="stegotpu-torch",
        description="secure video steganography (ECC + DCT/QIM) on an "
                    "NVIDIA GPU: the PyTorch/CUDA port of stegotpu",
    )
    p.add_argument("-v", "--verbose", action="store_true",
                   help="debug-level logging")
    p.add_argument("--device", default=None, metavar="DEVICE",
                   help="torch device of the QIM kernels (default: the CUDA "
                        "card; 'cpu' runs their plain PyTorch versions)")
    p.add_argument("--host-devices", type=int, default=None, metavar="N",
                   help="with --device cpu: N CPU devices for --mesh runs "
                        "without a card")
    p.add_argument("--version", action="version",
                   version=f"stegotpu_torch {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("genkey", help="create a receiver ECC keypair (PEM)")
    g.add_argument("--private", default="bob_private_key.pem")
    g.add_argument("--public", default="bob_public_key.pem")
    g.add_argument("--force", action="store_true")
    g.add_argument("--passphrase", action="store_true",
                   help="encrypt the private PEM at rest (PKCS8): the "
                        "passphrase comes from STEGOTPU_KEY_PASSPHRASE or "
                        "an interactive prompt, never argv")
    g.set_defaults(fn=cmd_genkey)

    e = sub.add_parser("embed", help="embed an encrypted secret image into a video")
    e.add_argument("cover", help="cover video path")
    e.add_argument("secret", help="secret image path")
    e.add_argument("output", help="output stego video path (.avi forced)")
    e.add_argument("--public-key", default="bob_public_key.pem")
    e.add_argument("--batch", type=int, default=8, help="frames per device batch")
    e.add_argument("--verified", action="store_true",
                   help="closed-loop embed repair: BER=0 even on saturated covers")
    e.add_argument("--allow-residual", action="store_true",
                   help="with --verified: emit the stego even if unrepairable "
                        "bits remain (default: fail the embed)")
    e.add_argument("--auto-fixtures", action="store_true",
                   help="generate reference-style dummy inputs for missing "
                        "cover/secret paths (reference README parity)")
    e.add_argument("--frame-range", default=None, metavar="LO:HI",
                   help="embed only source frames [LO, HI) as a SEGMENT "
                        "(bit offsets stay globally consistent; LO must "
                        "align to --batch; omit HI for to-EOF); stitch "
                        "segments with `concat`")
    e.add_argument("--payload-state", default=None, metavar="FILE.npy",
                   help="persist/reuse the sealed payload across segment "
                        "runs (separate invocations must embed the same "
                        "crypto stream); created on first use")
    _add_procs_flags(e)
    e.add_argument("--timing", action="store_true",
                   help="print decode/device/encode stage timing to stderr")
    _add_qim_flags(e)
    _add_codec_flag(e)
    _add_mesh_flag(e)
    e.set_defaults(fn=cmd_embed)

    eb = sub.add_parser("embed-batch",
                        help="embed one secret into many covers")
    eb.add_argument("secret", help="secret image path")
    eb.add_argument("covers", nargs="+", help="cover video paths")
    eb.add_argument("--out-dir", required=True,
                    help="output directory (stego named <cover-stem>.avi)")
    eb.add_argument("--public-key", default="bob_public_key.pem")
    eb.add_argument("--batch", type=int, default=8)
    eb.add_argument("--jobs", type=int, default=0,
                    help="files processed concurrently (0 = auto: 2 on "
                         "multi-core hosts, 1 on single-core)")
    _add_qim_flags(eb)
    _add_codec_flag(eb)
    eb.set_defaults(fn=cmd_embed_batch)

    xb = sub.add_parser("extract-batch", help="extract from many stego videos")
    xb.add_argument("stegos", nargs="+", help="stego video paths")
    xb.add_argument("--out-dir", required=True,
                    help="output directory (<stego-stem>.png / .bin)")
    xb.add_argument("--private-key", default="bob_private_key.pem")
    xb.add_argument("--batch", type=int, default=8)
    xb.add_argument("--jobs", type=int, default=0,
                    help="files processed concurrently (0 = auto)")
    _add_qim_flags(xb)
    xb.set_defaults(fn=cmd_extract_batch)

    def _add_dist_flags(p):
        p.add_argument("--coordinator", required=True, metavar="HOST:PORT",
                       help="rank 0's torch.distributed rendezvous address "
                            "(any free port)")
        p.add_argument("--num-processes", type=int, required=True)
        p.add_argument("--process-id", type=int, required=True)
        p.add_argument("--batch", type=int, default=8)
        _add_qim_flags(p)

    de = sub.add_parser(
        "dist-embed",
        help="cooperative multi-process embed (run one process per host; "
             "needs the native concat layer)")
    de.add_argument("cover")
    de.add_argument("secret")
    de.add_argument("output")
    de.add_argument("--public-key", default="bob_public_key.pem")
    de.add_argument("--seed", type=int, default=None,
                    help="deterministic crypto stream (tests/demos only — "
                         "weakens the ephemeral-key security!)")
    de.add_argument("--verified", action="store_true",
                    help="closed-loop embed repair per segment (BER=0 even "
                         "on saturated covers)")
    de.add_argument("--allow-residual", action="store_true")
    de.add_argument("--mesh", default=None, metavar="data=N,space=M",
                    help="PER-PROCESS device mesh for each segment (local "
                         "devices; the cross-process scatter is the segment "
                         "split)")
    _add_dist_flags(de)
    _add_codec_flag(de)
    de.set_defaults(fn=cmd_dist_embed)

    dx = sub.add_parser(
        "dist-extract",
        help="cooperative multi-process extract (run one process per host)")
    dx.add_argument("stego")
    dx.add_argument("output")
    dx.add_argument("--private-key", default="bob_private_key.pem")
    dx.add_argument("--mesh", default=None, metavar="data=N,space=M",
                    help="PER-PROCESS device mesh for each segment's extract")
    _add_dist_flags(dx)
    dx.set_defaults(fn=cmd_dist_extract)

    sv = sub.add_parser(
        "serve",
        help="warm-process JSON-over-HTTP daemon (localhost pipelines)")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (default localhost only — the API "
                         "reads/writes server-side paths, unauthenticated)")
    sv.add_argument("--port", type=int, default=8752)
    sv.set_defaults(fn=cmd_serve)

    ed = sub.add_parser("embed-data",
                        help="embed an arbitrary file's bytes (extension mode)")
    ed.add_argument("cover", help="cover video path")
    ed.add_argument("data_file", help="file whose bytes to embed")
    ed.add_argument("output", help="output stego video path (.avi forced)")
    ed.add_argument("--public-key", default="bob_public_key.pem")
    ed.add_argument("--batch", type=int, default=8)
    _add_procs_flags(ed)
    _add_qim_flags(ed)
    _add_codec_flag(ed)
    ed.set_defaults(fn=cmd_embed_data)

    x = sub.add_parser("extract", help="extract the secret (image or raw data)")
    x.add_argument("stego", help="stego video path")
    x.add_argument("output", help="output image path (PNG)")
    x.add_argument("--private-key", default="bob_private_key.pem")
    x.add_argument("--batch", type=int, default=8)
    x.add_argument("--timing", action="store_true",
                   help="print decode/device/encode stage timing to stderr")
    x.add_argument("--auto-params", action="store_true",
                   help="RECOVERY MODE: if extraction fails, recover "
                        "delta/coeffs from the stego's QIM lattice "
                        "(steganalysis) and retry")
    _add_procs_flags(x)
    _add_qim_flags(x)
    _add_mesh_flag(x)
    x.set_defaults(fn=cmd_extract)

    v = sub.add_parser("evaluate", help="PSNR/SSIM quality + crypto cost report")
    v.add_argument("original", help="original cover video")
    v.add_argument("stego", help="stego video")
    v.add_argument("--secret", default=None, help="original secret image")
    v.add_argument("--extracted", default=None, help="extracted secret image")
    v.add_argument("--dump-frames", default=None, help="dir for first-frame PNG dumps")
    v.add_argument("--crypto-timings", action="store_true")
    v.add_argument("--all-frames", action="store_true",
                   help="compare every frame pair, not just the first")
    v.add_argument("--max-frames", type=int, default=None)
    v.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser("capacity", help="embedding capacity of a cover video")
    c.add_argument("video")
    c.add_argument("--json", action="store_true", help="one-line JSON output")
    _add_qim_flags(c)
    c.set_defaults(fn=cmd_capacity)

    f = sub.add_parser("fixtures", help="generate demo cover video + secret image")
    f.add_argument("--dir", default="media/input")
    f.add_argument("--width", type=int, default=640)
    f.add_argument("--height", type=int, default=480)
    f.add_argument("--frames", type=int, default=48)
    f.add_argument("--secret-size", type=int, default=64)
    f.add_argument("--kind", choices=["moving", "noise"], default="moving")
    f.set_defaults(fn=cmd_fixtures)

    b = sub.add_parser("bench", help="run the headline benchmark on the card")
    b.set_defaults(fn=cmd_bench)

    cc = sub.add_parser(
        "concat",
        help="stitch same-codec video segments (packet copy, no re-encode)")
    cc.add_argument("output", help="output .avi path")
    cc.add_argument("segments", nargs="+", help="segment files, in order")
    cc.set_defaults(fn=cmd_concat)

    i = sub.add_parser("inspect", help="parse a stego header without decrypting")
    i.add_argument("stego", help="stego video path")
    i.add_argument("--json", action="store_true", help="one-line JSON output")
    _add_qim_flags(i)
    i.set_defaults(fn=cmd_inspect)

    z = sub.add_parser("steganalyze",
                       help="detect QIM embedding / estimate delta (no keys)")
    z.add_argument("video")
    z.add_argument("--coeffs", type=int, default=10)
    z.add_argument("--max-frames", type=int, default=4)
    z.add_argument("--json", action="store_true", help="one-line JSON output")
    z.set_defaults(fn=cmd_steganalyze)

    s = sub.add_parser("selftest", help="one-command end-to-end smoke test")
    s.add_argument("--dir", default=None, help="work dir (default: temp)")
    _add_qim_flags(s)
    _add_mesh_flag(s)
    s.add_argument("--verified", action="store_true")
    s.set_defaults(fn=cmd_selftest)
    return p


def main(argv=None) -> int:
    from stegotpu_torch.utils.logging import configure as configure_logging

    args = build_parser().parse_args(argv)
    configure_logging(verbose=getattr(args, "verbose", False))
    try:
        ret = args.fn(args)
        # flush INSIDE the try: with piped stdout Python block-buffers, so
        # a closed pipe only surfaces at shutdown flush — outside any
        # handler — unless we force it here
        sys.stdout.flush()
        return ret
    except BrokenPipeError:
        # stdout consumer went away (e.g. `... | head`): terminate silently,
        # and point the fd at devnull so the interpreter's shutdown flush
        # cannot raise a second BrokenPipeError
        import os

        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0
    except (OSError, ValueError, RuntimeError) as e:
        # RuntimeError: no CUDA device where the card is the default
        # (device.resolve_device), a kernel build or launch that failed
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
