"""setup_s (s): from the harness's start to the window's: imports, the
device, the kernel library, inputs and warm-up (host clock)."""

def read(rec):
    return rec.setup_s
