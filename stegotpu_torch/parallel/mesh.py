"""Device-mesh scaling for the stego kernels.

Counterpart of ``stegotpu/parallel/mesh.py``. The workload is
embarrassingly parallel at two levels, mapped onto a 2-D mesh:

- ``data`` axis: frames of the batch are independent -> frame-axis data
  parallelism (dp);
- ``space`` axis: 8-pixel block *rows* within a frame are independent ->
  spatial sharding (sp) of the H axis, for engaging many devices on a single
  high-resolution stream at low batch.

Payload routing needs no communication: per-slot global bit indices are
statically computable, and because bits are consumed block-row-major, the
(B, C) frame-major payload matrix shards *directly* on ('data', 'space') —
the columns belonging to a height-stripe are contiguous. Each shard embeds
its slice against a global ``bit_offset`` (Python ints, int64 in the
kernels); the only reductions are the bits per frame over 'space' and the
error count of the round-trip step over the whole mesh.

A mesh is an (n_data, n_space) grid of torch devices. Where the JAX package
runs the per-device program under ``shard_map``, the port scatters and
gathers explicitly: every shard is its own contiguous tensor on its device
(the CUDA wrappers refuse a strided view, and a block-row slice of a
(B, H, W) tensor is one), the single-device kernel runs on it unchanged, and
the results come back to the mesh's first device, where a ``psum`` becomes a
sum of the shards' tensors. The same device may appear more than once: a
2x3 grid over one card (or the CPU) runs its six shards one after another,
the counterpart of the JAX tests' virtual CPU devices.

A mesh that spans processes (parallel/distributed.global_mesh) names every
process's devices, and each process feeds and gets back only its own rows of
the 'data' axis (``Mesh.data_rows``): the per-process shard bookkeeping that
``to_global``/``to_host_local`` do in the JAX package. Its error count is
summed over the processes with torch.distributed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stegotpu_torch.config import BLOCK
from stegotpu_torch.device import resolve_device

# partition specs, one mesh axis name (or None) per dimension
FRAMES = ("data", "space", None)   # (B, H, W)
PAYLOAD = ("data", "space")        # (B, C): stripe columns are contiguous


def _kernel_fns(kernel: str):
    """Per-shard kernel selection: 'pallas' runs the stripe kernels (K1 and
    K2 with the wire-order unpack, ops/stripe_kernel.py: the CUDA kernels
    on a CUDA shard, their plain versions on a CPU shard), anything else the
    f32 oracle (ops/qim.py), as the JAX package's 'xla'."""
    if kernel == "pallas":
        from stegotpu_torch.ops import stripe_kernel

        return stripe_kernel.embed_frames, stripe_kernel.extract_frames
    from stegotpu_torch.ops import qim

    return qim.embed_frames, qim.extract_frames


def _require_default_block(block: int) -> None:
    """The per-shard kernel calls run at the standard 8-px block; a different
    `block` would silently misalign the payload offset arithmetic."""
    if block != BLOCK:
        raise NotImplementedError(
            f"sharded kernels support block={BLOCK} only (got {block})"
        )


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (n_data, n_space) grid of torch devices with the axis names
    'data' and 'space'. data_rows: the rows of the 'data' axis whose frames
    this process feeds and gets back — all of them, except on a mesh that
    spans processes."""

    devices: np.ndarray  # (n_data, n_space), dtype object: torch.device
    data_rows: range

    @property
    def shape(self) -> dict[str, int]:
        n_data, n_space = self.devices.shape
        return {"data": n_data, "space": n_space}

    @property
    def spans_processes(self) -> bool:
        return len(self.data_rows) != self.devices.shape[0]

    @property
    def first_device(self) -> torch.device:
        """Where the shards' results are gathered: this process's first."""
        return self.devices[self.data_rows[0], 0]

    def shard(self, x: torch.Tensor, spec) -> dict:
        """This process's shards of x, {(di, si): tensor}: x holds the
        process's data rows, and shard (di, si) is its block under `spec`
        as its own contiguous tensor on devices[di, si]."""
        n = {"data": len(self.data_rows), "space": self.shape["space"]}
        for dim, axis in enumerate(spec):
            if axis is not None and x.shape[dim] % n[axis]:
                raise ValueError(
                    f"mesh axis {axis}={n[axis]} does not divide dimension "
                    f"{dim} of shape {tuple(x.shape)}")
        shards = {}
        for li, di in enumerate(self.data_rows):
            for si in range(n["space"]):
                k = {"data": li, "space": si}
                index = tuple(
                    slice(None) if axis is None else
                    slice(k[axis] * (x.shape[dim] // n[axis]),
                          (k[axis] + 1) * (x.shape[dim] // n[axis]))
                    for dim, axis in enumerate(spec))
                shards[di, si] = x[index].contiguous().to(
                    self.devices[di, si])
        return shards

    def gather(self, shards: dict, spec) -> torch.Tensor:
        """The inverse of shard, on first_device: the shards concatenated
        along the dimensions `spec` names; an axis it leaves out holds
        replicas, of which the first is taken."""
        dev = self.first_device
        rows = []
        for di in self.data_rows:
            if "space" in spec:
                rows.append(torch.cat(
                    [shards[di, si].to(dev)
                     for si in range(self.shape["space"])],
                    spec.index("space")))
            else:
                rows.append(shards[di, 0].to(dev))
        return torch.cat(rows, spec.index("data")) if "data" in spec \
            else rows[0]


def _grid(devices, n_data: int, n_space: int) -> np.ndarray:
    grid = np.empty((n_data, n_space), dtype=object)
    for i, d in enumerate(devices[: n_data * n_space]):
        grid[divmod(i, n_space)] = torch.device(d)
    return grid


def local_devices(device=None, host_devices: int | None = None
                  ) -> list[torch.device]:
    """This process's devices for a mesh: every CUDA card when `device` is
    None (device.resolve_device: the card) or a CUDA device; the CPU
    `host_devices` times (default once) when it is the CPU — the
    counterpart of the JAX CLI's --host-devices N virtual CPU devices."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * (host_devices or 1)
    if host_devices:
        raise ValueError("--host-devices N counts CPU devices; it needs "
                         "--device cpu")
    return [torch.device(device.type, i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices=None) -> Mesh:
    """Build a ('data', 'space') mesh. Defaults to all devices on 'data'.
    devices: an explicit list (the same device may repeat), default
    local_devices()."""
    devices = list(devices) if devices is not None else local_devices()
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space > len(devices):
        raise ValueError(f"a {n_data}x{n_space} mesh needs "
                         f"{max(n_data, 1) * n_space} devices, got "
                         f"{len(devices)}")
    return Mesh(_grid(devices, n_data, n_space), range(n_data))


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """Parse a 'data=N,space=M' mesh spec string (the --mesh CLI flag).

    Either axis may be omitted (defaults to 1); bare integers mean
    data-parallel only ('4' == 'data=4').
    """
    n_data, n_space = 1, 1
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in ("data", "space"):
                raise ValueError(f"unknown mesh axis {k!r} (use data/space)")
            n = int(v)
        else:
            k, n = "data", int(part)
        if n < 1:
            raise ValueError(f"mesh axis {k} must be >= 1, got {n}")
        if k == "data":
            n_data = n
        else:
            n_space = n
    return n_data, n_space


def product_mesh(spec: str, devices=None) -> Mesh:
    """Build the ('data', 'space') mesh a --mesh flag names, with a clear
    error when the host lacks the devices. devices defaults to
    local_devices(): the CUDA cards, or on the CPU the count --host-devices
    sets."""
    n_data, n_space = parse_mesh_spec(spec)
    devices = list(devices) if devices is not None else local_devices()
    if n_data * n_space > len(devices):
        plat = devices[0].type if devices else "none"
        raise ValueError(
            f"mesh {spec!r} needs {n_data * n_space} devices but only "
            f"{len(devices)} are available ({plat}); on CPU, "
            "raise the count with --host-devices N"
        )
    return make_mesh(n_data, n_space, devices)


def _shard_offsets(h_l: int, w_l: int, num_ac: int, n_space: int,
                   block: int):
    """Per-shard payload geometry: (stripe capacity, full-frame capacity)."""
    cap_stripe = (h_l // block) * (w_l // block) * num_ac
    return cap_stripe, cap_stripe * n_space


def _embed_local(embed, frames, payload, total_bits: int, delta: float, *,
                 di: int, si: int, num_ac: int, n_space: int, block: int):
    """Embed over shard (di, si), a (b_l, h_l, w_l) frame block.

    Local frame f / stripe si holds global bits
    [(di*b_l + f)*cap_frame + si*cap_stripe, ... + cap_stripe); each frame
    is embedded with its own global offset (frames advance by cap_frame
    globally but only cap_stripe locally, so the batched single-offset form
    cannot be used across frames).
    """
    b_l, h_l, w_l = frames.shape
    cap_stripe, cap_frame = _shard_offsets(h_l, w_l, num_ac, n_space, block)
    if n_space == 1:
        # full-frame shards: cap_frame == cap_stripe, so the kernel's
        # internal f*cap stride IS the global stride and one batched call
        # reproduces the per-frame calls bit for bit
        return embed(frames, payload, total_bits, delta, num_ac,
                     bit_offset=di * b_l * cap_frame)
    outs = [embed(frames[f : f + 1], payload[f : f + 1], total_bits, delta,
                  num_ac,
                  bit_offset=(di * b_l + f) * cap_frame + si * cap_stripe)
            for f in range(b_l)]
    return (torch.cat([stego for stego, _ in outs]),
            torch.cat([bpf for _, bpf in outs]))


def _sum_over_space(mesh: Mesh, shards: dict) -> torch.Tensor:
    """psum over 'space', gathered over 'data': the bits per frame."""
    dev = mesh.first_device
    return torch.cat([sum(shards[di, si].to(dev)
                          for si in range(mesh.shape["space"]))
                      for di in mesh.data_rows])


def _sharded_embed(mesh, embed, frames, payload, total_bits, delta, num_ac,
                   block):
    frames_sh = mesh.shard(frames, FRAMES)
    payload_sh = mesh.shard(payload, PAYLOAD)
    out = {key: _embed_local(embed, frames_sh[key], payload_sh[key],
                             int(total_bits), float(delta), di=key[0],
                             si=key[1], num_ac=num_ac,
                             n_space=mesh.shape["space"], block=block)
           for key in frames_sh}
    return payload_sh, out


def sharded_embed_frames(mesh: Mesh, num_ac: int, block: int = BLOCK,
                         kernel: str = "xla", precision: str = "wire"):
    """dp x sp sharded embed: fn(frames, payload, total_bits, delta) ->
    (stego (B, H, W) uint8, bits per frame (B,) int32) on the mesh's first
    device.

    frames (B, H, W) shard as ('data', 'space', None); payload (B, C) as
    ('data', 'space') — C columns are block-row-major so stripe bits are
    contiguous. B must divide by the 'data' size and H//block by 'space'.
    The bits per frame are summed over stripes. precision: accepted for
    interchangeability with the JAX package (the port computes the f32 wire
    arithmetic under both names).
    """
    _require_default_block(block)
    embed, _ = _kernel_fns(kernel)

    def fn(frames, payload, total_bits, delta):
        _, out = _sharded_embed(mesh, embed, frames, payload, total_bits,
                                   delta, num_ac, block)
        return (mesh.gather({k: v[0] for k, v in out.items()}, FRAMES),
                _sum_over_space(mesh, {k: v[1] for k, v in out.items()}))

    return fn


def sharded_extract_frames(mesh: Mesh, num_ac: int, block: int = BLOCK,
                           kernel: str = "xla", precision: str = "wire"):
    """dp x sp sharded extract: fn(frames, delta) -> (B, C) bits on the
    mesh's first device, purely local compute per shard."""
    _require_default_block(block)
    _, extract = _kernel_fns(kernel)

    def fn(frames, delta):
        frames_sh = mesh.shard(frames, FRAMES)
        return mesh.gather({k: extract(x, float(delta), num_ac)
                            for k, x in frames_sh.items()}, PAYLOAD)

    return fn


def sharded_roundtrip_step(mesh: Mesh, num_ac: int, block: int = BLOCK,
                           kernel: str = "xla", precision: str = "wire"):
    """Sharded embed -> extract -> global BER in one call.

    fn(frames, payload, total_bits, delta) -> (stego, bits_per_frame,
    extracted_bits, total_errors): total_errors, a 0-dim int64 tensor on
    the mesh's first device, counts mismatches on payload-carrying slots
    only, summed over every shard of the mesh (over every process of a mesh
    that spans processes).
    """
    _require_default_block(block)
    embed, extract = _kernel_fns(kernel)
    n_space = mesh.shape["space"]

    def fn(frames, payload, total_bits, delta):
        total_bits = int(total_bits)
        payload_sh, out = _sharded_embed(mesh, embed, frames, payload,
                                            total_bits, delta, num_ac, block)
        extracted, errors = {}, {}
        for (di, si), (stego, _) in out.items():
            b_l, h_l, w_l = stego.shape
            cap_stripe, cap_frame = _shard_offsets(h_l, w_l, num_ac, n_space,
                                                   block)
            bits = extract(stego, float(delta), num_ac)
            # mask: count errors only on slots that actually carry payload
            col = torch.arange(cap_stripe, dtype=torch.int64,
                               device=bits.device)[None, :]
            frame_idx = di * b_l + torch.arange(
                b_l, dtype=torch.int64, device=bits.device)[:, None]
            slot_global = frame_idx * cap_frame + si * cap_stripe + col
            extracted[di, si] = bits
            errors[di, si] = ((slot_global < total_bits)
                              & (bits != payload_sh[di, si])).sum()
        dev = mesh.first_device
        total_errors = sum(e.to(dev) for e in errors.values())
        if mesh.spans_processes:
            import torch.distributed as dist

            host = total_errors.cpu()
            dist.all_reduce(host)  # the psum over the processes' rows
            total_errors = host.to(dev)
        return (mesh.gather({k: v[0] for k, v in out.items()}, FRAMES),
                _sum_over_space(mesh, {k: v[1] for k, v in out.items()}),
                mesh.gather(extracted, PAYLOAD), total_errors)

    return fn
