"""Tkinter GUI: embed / extract / genkey with live log and quality readouts.

Counterpart of ``stegotpu/gui.py``, run through ``stegotpu_torch``: the
same window (three radio modes, file pickers, delta/coefficient spinboxes
bounded [1,100] / [1,63], kernel/codec/precision/procs knobs, verified and
auto-recover checkboxes, a scrolled log), the same worker threads and the
same messages.

Design kept from the JAX package:
- worker threads never touch Tk state directly — results and log lines go
  through a queue drained by `after()` on the main thread;
- every Tk value is SNAPSHOT on the main thread before a worker starts
  (``_run``); the workers read only the snapshot, so they run headless;
- no global stdout redirection; the log uses an explicit callback;
- the mode-selector frame is built once.

What differs: ``StegoApp(root, device=None)`` resolves its device once
(the card unless the caller names another; device.resolve_device raises
where there is none) and puts it into the snapshot, and the workers pass
it to every pipeline call. ``tkinter`` is imported where a window is
built, never at module level, so the worker logic imports and runs on a
machine without Tk.
"""

from __future__ import annotations

import logging
import queue
import threading

from stegotpu_torch.config import StegoConfig
from stegotpu_torch.device import resolve_device


class QueueLogHandler(logging.Handler):
    """Streams pipeline log records into the GUI queue (thread-safe).

    Every pipeline log line (including per-batch progress at DEBUG)
    appears live in the GUI log — via the logging system and the Tk-safe
    queue instead of hijacking global stdout from a worker thread.
    """

    _TAGS = {logging.DEBUG: "INFO", logging.INFO: "INFO",
             logging.WARNING: "RUN", logging.ERROR: "ERR"}

    def __init__(self, q: queue.Queue):
        super().__init__(level=logging.DEBUG)
        self._q = q

    def emit(self, record: logging.LogRecord) -> None:
        tag = self._TAGS.get(record.levelno, "ERR" if
                             record.levelno >= logging.ERROR else "INFO")
        self._q.put(("log", self.format(record), tag))


class StegoApp:
    def __init__(self, root, device=None):
        import tkinter as tk

        self.root = root
        self.device = resolve_device(device)
        root.title("stegotpu_torch — secure video steganography (CUDA)")
        self._q: queue.Queue = queue.Queue()
        self.mode = tk.StringVar(value="embed")
        self.delta = tk.IntVar(value=20)
        self.coeffs = tk.IntVar(value=10)
        self.kernel = tk.StringVar(value="auto")
        self.codec = tk.StringVar(value="FFV1")
        self.precision = tk.StringVar(value="wire")
        self.procs = tk.StringVar(value="1")
        self.verified = tk.BooleanVar(value=False)
        self.auto_recover = tk.BooleanVar(value=False)
        # live pipeline log: every stegotpu_torch log record (incl.
        # per-batch DEBUG progress) streams into the GUI through the queue.
        # A stale handler from a previous window would leak records into a
        # dead queue forever — replace, never accumulate.
        logger = logging.getLogger("stegotpu_torch")
        for h in list(logger.handlers):
            if isinstance(h, QueueLogHandler):
                logger.removeHandler(h)
        if logger.level == logging.NOTSET or logger.level > logging.DEBUG:
            # the GUI handler needs DEBUG records; pin pre-existing
            # handlers to the logger's previous effective level so they
            # don't suddenly start emitting DEBUG too
            prev = logger.getEffectiveLevel()
            for h in logger.handlers:
                if h.level == logging.NOTSET:
                    h.setLevel(prev)
            logger.setLevel(logging.DEBUG)
        logger.addHandler(QueueLogHandler(self._q))
        self.paths = {
            "cover": tk.StringVar(),
            "secret": tk.StringVar(),
            "stego_out": tk.StringVar(value="media/output/stego_video.avi"),
            "stego_in": tk.StringVar(),
            "image_out": tk.StringVar(value="media/output/extracted_secret.png"),
            "pub_key": tk.StringVar(value="bob_public_key.pem"),
            "priv_key": tk.StringVar(value="bob_private_key.pem"),
        }
        self._build()
        self._drain()

    # --- layout -------------------------------------------------------------

    def _build(self) -> None:
        from tkinter import scrolledtext, ttk

        top = ttk.Frame(self.root, padding=8)
        top.pack(fill="x")
        for mode, label in [("embed", "Embed"), ("extract", "Extract"),
                            ("genkey", "Generate keys")]:
            ttk.Radiobutton(top, text=label, value=mode, variable=self.mode,
                            command=self._refresh_fields).pack(side="left", padx=4)

        self.fields = ttk.Frame(self.root, padding=8)
        self.fields.pack(fill="x")

        params = ttk.Frame(self.root, padding=8)
        params.pack(fill="x")
        ttk.Label(params, text="delta [1,100]:").pack(side="left")
        ttk.Spinbox(params, from_=1, to=100, textvariable=self.delta,
                    width=5).pack(side="left", padx=4)
        ttk.Label(params, text="AC coeffs [1,63]:").pack(side="left")
        ttk.Spinbox(params, from_=1, to=63, textvariable=self.coeffs,
                    width=5).pack(side="left", padx=4)
        ttk.Label(params, text="kernel:").pack(side="left", padx=(8, 0))
        ttk.Combobox(params, textvariable=self.kernel, width=7,
                     state="readonly",
                     values=("auto", "xla", "pallas")).pack(side="left", padx=4)
        ttk.Label(params, text="codec:").pack(side="left")
        ttk.Combobox(params, textvariable=self.codec, width=6,
                     state="readonly",
                     values=("FFV1", "HFYU", "RGBA")).pack(side="left",
                                                           padx=4)
        ttk.Label(params, text="precision:").pack(side="left")
        ttk.Combobox(params, textvariable=self.precision, width=5,
                     state="readonly",
                     values=("wire", "fast")).pack(side="left", padx=4)
        ttk.Label(params, text="procs:").pack(side="left")
        ttk.Combobox(params, textvariable=self.procs, width=5,
                     values=("1", "2", "4", "8", "auto")).pack(side="left",
                                                              padx=4)
        ttk.Checkbutton(params, text="verified (BER=0)",
                        variable=self.verified).pack(side="left", padx=4)
        ttk.Checkbutton(params, text="auto-recover params",
                        variable=self.auto_recover).pack(side="left", padx=4)
        self.run_btn = ttk.Button(params, text="Run", command=self._run)
        self.run_btn.pack(side="right")

        self.log = scrolledtext.ScrolledText(self.root, height=18, width=90,
                                             state="disabled")
        self.log.pack(fill="both", expand=True, padx=8, pady=8)
        for tag, color in [("INFO", "black"), ("OK", "dark green"),
                           ("ERR", "red"), ("RUN", "navy")]:
            self.log.tag_config(tag, foreground=color)
        self._refresh_fields()

    def _picker(self, row: int, label: str, var, save: bool = False,
                types=None) -> None:
        from tkinter import filedialog, ttk

        ttk.Label(self.fields, text=label).grid(row=row, column=0, sticky="w")
        ttk.Entry(self.fields, textvariable=var, width=60).grid(row=row, column=1,
                                                                padx=4)
        def browse():
            fn = (filedialog.asksaveasfilename if save
                  else filedialog.askopenfilename)(filetypes=types or [])
            if fn:
                var.set(fn)
        ttk.Button(self.fields, text="...", command=browse, width=3).grid(
            row=row, column=2)

    def _refresh_fields(self) -> None:
        for child in self.fields.winfo_children():
            child.destroy()
        mode = self.mode.get()
        if mode == "embed":
            self._picker(0, "Cover video:", self.paths["cover"],
                         types=[("video", "*.mp4 *.avi *.mkv"), ("all", "*")])
            self._picker(1, "Secret image:", self.paths["secret"],
                         types=[("image", "*.png *.jpg *.bmp"), ("all", "*")])
            self._picker(2, "Stego output (.avi):", self.paths["stego_out"], save=True)
            self._picker(3, "Receiver public key:", self.paths["pub_key"],
                         types=[("PEM", "*.pem")])
        elif mode == "extract":
            self._picker(0, "Stego video:", self.paths["stego_in"],
                         types=[("video", "*.avi"), ("all", "*")])
            self._picker(1, "Extracted image out:", self.paths["image_out"], save=True)
            self._picker(2, "Receiver private key:", self.paths["priv_key"],
                         types=[("PEM", "*.pem")])
            self._picker(3, "Original secret (optional, for PSNR/SSIM):",
                         self.paths["secret"])
        else:
            self._picker(0, "Private key path:", self.paths["priv_key"], save=True)
            self._picker(1, "Public key path:", self.paths["pub_key"], save=True)

    # --- logging (thread-safe via queue) -------------------------------------

    def _log(self, msg: str, tag: str = "INFO") -> None:
        self._q.put(("log", msg, tag))

    def _drain(self) -> None:
        try:
            while True:
                kind, *rest = self._q.get_nowait()
                if kind == "log":
                    msg, tag = rest
                    self.log.configure(state="normal")
                    self.log.insert("end", msg + "\n", tag)
                    self.log.see("end")
                    self.log.configure(state="disabled")
                elif kind == "preview":
                    self._show_preview(rest[0])
                elif kind == "done":
                    self.run_btn.configure(state="normal")
        except queue.Empty:
            pass
        self.root.after(100, self._drain)

    def _show_preview(self, path: str) -> None:
        """Pop up the recovered secret. Runs on the Tk main thread only —
        workers request it through the queue."""
        import tkinter as tk

        try:
            img = tk.PhotoImage(file=path)
            zoom = max(1, 128 // max(1, img.width(), img.height()))
            if zoom > 1:
                img = img.zoom(zoom, zoom)
            win = tk.Toplevel(self.root)
            win.title(f"extracted secret — {path}")
            label = tk.Label(win, image=img)
            label.image = img  # keep a reference or Tk garbage-collects it
            label.pack(padx=8, pady=8)
        except tk.TclError as e:
            self._log(f"preview unavailable: {e}", "INFO")

    # --- operations ----------------------------------------------------------

    def _run(self) -> None:
        mode = self.mode.get()
        if mode == "genkey" and not self._confirm_genkey_overwrite():
            self._log("key generation cancelled", "INFO")
            return
        # SNAPSHOT every Tk value on the main thread: workers must never
        # call .get() on Tk variables (unsafe on non-thread-enabled Tcl,
        # and racy against mid-run spinbox edits even on threaded builds)
        snap = {
            "paths": {k: v.get() for k, v in self.paths.items()},
            "config": self._config(),
            "procs": self._procs_value(),
            "auto_recover": bool(self.auto_recover.get()),
            "device": self.device,
        }
        self.run_btn.configure(state="disabled")
        worker = {"embed": self._do_embed, "extract": self._do_extract,
                  "genkey": self._do_genkey}[mode]
        threading.Thread(target=self._guard(worker, snap),
                         daemon=True).start()

    def _confirm_genkey_overwrite(self) -> bool:
        """Overwrite confirmation MUST happen on the Tk main thread (this
        runs in the button callback); workers never touch Tk state."""
        import os
        from tkinter import messagebox

        priv_p = self.paths["priv_key"].get()
        pub_p = self.paths["pub_key"].get()
        if not (os.path.exists(priv_p) or os.path.exists(pub_p)):
            return True
        return messagebox.askyesno("Overwrite keys?", "Key files exist. Overwrite?")

    def _guard(self, fn, snap):
        def wrapped():
            try:
                fn(snap)
            except Exception as e:  # surface, don't crash the worker silently
                self._log(f"ERROR: {e}", "ERR")
            finally:
                self._q.put(("done",))
        return wrapped

    def _config(self) -> StegoConfig:
        return StegoConfig(delta=self.delta.get(),
                           num_ac_coeffs=self.coeffs.get(),
                           kernel=self.kernel.get(), codec=self.codec.get(),
                           verified_embed=self.verified.get(),
                           qim_precision=self.precision.get())

    def _procs_value(self):
        """The procs knob: 'auto', or an int (1 = plain pipeline)."""
        v = (self.procs.get() or "1").strip()
        if v == "auto":
            return v
        try:
            return max(1, int(v))
        except ValueError:
            self._log(f"ignoring invalid procs value {v!r}", "ERR")
            return 1

    def _do_genkey(self, snap) -> None:
        # overwrite was already confirmed on the main thread (_run).
        # NEVER delete the old keypair before the new one exists: generate
        # into temp files and swap atomically, so a generation failure
        # cannot lose the private key protecting existing stego videos
        import os
        from pathlib import Path

        from stegotpu_torch import crypto

        priv_p = snap["paths"]["priv_key"]
        pub_p = snap["paths"]["pub_key"]
        self._log("generating SECP256R1 keypair...", "RUN")
        if os.path.exists(priv_p) or os.path.exists(pub_p):
            tmp_priv, tmp_pub = priv_p + ".new", pub_p + ".new"
            Path(tmp_priv).unlink(missing_ok=True)
            Path(tmp_pub).unlink(missing_ok=True)
            crypto.setup_receiver_keys(tmp_priv, tmp_pub)
            os.replace(tmp_priv, priv_p)
            os.replace(tmp_pub, pub_p)
        else:
            crypto.setup_receiver_keys(priv_p, pub_p)
        self._log(f"wrote {priv_p} and {pub_p}", "OK")

    def _do_embed(self, snap) -> None:
        from stegotpu_torch import crypto
        from stegotpu_torch.pipeline import embed_image_in_video

        self._log("embedding...", "RUN")
        paths, cfg, procs = snap["paths"], snap["config"], snap["procs"]
        device = snap["device"]
        pub = crypto.serialize_public_compressed(
            crypto.load_public_pem(paths["pub_key"])
        )
        if procs != 1:
            from stegotpu_torch.parallel.local_procs import parallel_embed

            res = parallel_embed(paths["cover"], paths["secret"],
                                 paths["stego_out"], pub, cfg, procs=procs,
                                 device=device)
        else:
            res = embed_image_in_video(paths["cover"], paths["secret"],
                                       paths["stego_out"], pub, cfg,
                                       device=device)
        if not res.success:
            if res.residual_bits:
                self._log(
                    f"EMBED FAILED: {res.residual_bits} unrepairable payload "
                    "bits after verified repair (saturated cover)", "ERR")
            else:
                reason = res.error or (
                    f"{res.bits_embedded}/{res.total_payload_bits} bits "
                    "before video ended")
                self._log(f"EMBED FAILED: {reason}", "ERR")
            return
        self._log(f"embedded {res.total_payload_bits} bits -> {res.output_path}", "OK")
        psnr = res.first_frame_psnr
        if psnr is not None:
            self._log(f"first-frame PSNR (orig vs stego gray): {psnr:.2f} dB", "OK")

    def _do_extract(self, snap) -> None:
        from stegotpu_torch import crypto
        from stegotpu_torch.evaluation import compare_images
        from stegotpu_torch.pipeline import extract_image_from_video

        self._log("extracting...", "RUN")
        paths, cfg, procs = snap["paths"], snap["config"], snap["procs"]
        device = snap["device"]
        priv = crypto.load_private_pem(paths["priv_key"])
        out = paths["image_out"]

        def run(run_cfg):
            if procs != 1:
                from stegotpu_torch.parallel.local_procs import parallel_extract

                return parallel_extract(paths["stego_in"], priv, run_cfg,
                                        out, procs=procs, device=device)
            return extract_image_from_video(paths["stego_in"], priv,
                                            run_cfg, out, device=device)

        res = run(cfg)
        if not res.success and snap["auto_recover"]:
            # RECOVERY MODE (mirrors `extract --auto-params` / the daemon's
            # auto_params): steganalysis.recover_params is the shared core
            from stegotpu_torch.steganalysis import recover_params

            self._log(
                f"extract failed with delta={cfg.delta}, "
                f"coeffs={cfg.num_ac_coeffs} — running steganalysis "
                "parameter recovery...", "RUN")
            new_cfg, msg = recover_params(paths["stego_in"], cfg,
                                          device=device)
            if new_cfg is not None:
                self._log(f"RECOVERY: {msg} — retrying", "RUN")
                cfg = new_cfg
                res = run(cfg)  # retry keeps the user's procs selection
                if res.success:
                    self._log(f"recovered parameters: delta={cfg.delta}, "
                              f"coeffs={cfg.num_ac_coeffs}", "OK")
            else:
                self._log(f"RECOVERY FAILED: {msg}", "ERR")
        if not res.success:
            self._log(f"EXTRACT FAILED: {res.error}", "ERR")
            return
        if res.is_raw_data:
            self._log(f"extracted {len(res.data)} bytes of raw data -> {out}",
                      "OK")
        else:
            self._log(
                f"extracted {res.parts.secret_width}x{res.parts.secret_height} "
                f"image -> {out}", "OK")
            self._q.put(("preview", out))
        self._log("SHA3-256 integrity: " + ("OK" if res.hash_ok else "MISMATCH"),
                  "OK" if res.hash_ok else "ERR")
        orig = paths["secret"]
        if orig and not res.is_raw_data:
            cmp = compare_images(orig, out)
            self._log(
                f"vs original secret: PSNR {cmp.psnr:.2f} dB, "
                f"SSIM {cmp.ssim:.4f} ({cmp.verdict})", "OK")


def main() -> None:
    """The window, on the card (raises where there is none)."""
    import tkinter as tk

    device = resolve_device()
    root = tk.Tk()
    StegoApp(root, device)
    root.mainloop()


if __name__ == "__main__":
    main()
