"""Multi-device and multi-process scaling (counterpart of stegotpu/parallel).

mesh: the ('data', 'space') device mesh and its sharded kernel calls.
distributed: a torch.distributed (Gloo) group, the process-major global mesh
and per-process input sharding.
dist_pipeline: cooperative multi-process file->file embed/extract (the
CLI's dist-embed / dist-extract).
local_procs: segment-parallel workers on one host (the CLI's --procs).
"""

from stegotpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    product_mesh,
    sharded_embed_frames,
    sharded_extract_frames,
    sharded_roundtrip_step,
)
