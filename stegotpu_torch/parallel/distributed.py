"""Multi-process scaling: a torch.distributed group and per-process input
sharding.

Counterpart of ``stegotpu/parallel/distributed.py``, with torch.distributed
in place of jax.distributed:

- ``initialize`` forms a Gloo group. The only collectives are small host
  tensors (the error count's all-reduce, the product pipelines' status,
  payload and bit gathers), and NCCL does not allow two ranks on one card;
- ``global_mesh`` is the process-major ('data', 'space') mesh over every
  process's devices: rank r owns a contiguous block of 'data' rows;
- each process decodes ITS OWN contiguous slice of the frame batch
  (``host_batch_slice``) and feeds it to its devices: no frame pixel crosses
  processes. What JAX assembles into a global array with
  ``to_global``/``to_host_local``, the port keeps as per-process shard
  bookkeeping: the sharded functions of parallel/mesh.py scatter and gather
  only the process's own rows (``Mesh.data_rows``), and the round-trip
  step's error count is all-reduced over the processes;
- payload routing still needs no communication: global bit offsets follow
  from the (data row, frame, stripe) index exactly as in the one-process
  mesh.

Nothing tells a program of a cluster, so ``initialize`` takes the
coordinator's address, the process count and this process's rank (or
reads torch.distributed's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK).
The dryrun below runs the sharded round trip as N processes
(tests/test_torch_multihost.py spawns two).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from stegotpu_torch.parallel.mesh import Mesh, _grid, local_devices


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or form) the Gloo process group.

    coordinator_address: 'HOST:PORT' of rank 0's rendezvous (any free
    port); None reads torch.distributed's environment variables instead.
    """
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def process_count() -> int:
    """The group's size, 1 outside a group (jax.process_count)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 outside a group (jax.process_index)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(n_data: int | None = None, n_space: int = 1,
                devices=None) -> Mesh:
    """('data', 'space') mesh over ALL processes' devices, process-major.

    devices: this process's devices (default mesh.local_devices()); every
    process must bring as many, a multiple of n_space, so that each owns
    len(devices)/n_space contiguous 'data' rows — the layout the input
    sharding below assumes. n_data, where given, must be their total.
    """
    local = list(devices) if devices is not None else local_devices()
    nproc, pid = process_count(), process_index()
    names = [[str(d) for d in local]]
    if nproc > 1:
        names = [None] * nproc
        dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1 or len(local) % n_space:
        raise ValueError(
            f"every process must bring the same number of devices, a "
            f"multiple of space={n_space}: got {[len(n) for n in names]}")
    rows = len(local) // n_space
    if n_data is not None and n_data != nproc * rows:
        raise ValueError(f"data={n_data} must be the {nproc * rows} rows of "
                         f"{nproc} processes' devices")
    everyone = [d for n in names for d in n]
    return Mesh(_grid(everyone, nproc * rows, n_space),
                range(pid * rows, (pid + 1) * rows))


def host_batch_slice(mesh: Mesh, batch_global: int) -> tuple[int, int]:
    """[start, stop) of the global frame batch THIS process must decode.

    This is the input-sharding contract: process i feeds frames
    [i*B/P, (i+1)*B/P) of each global batch to its local devices; a long
    video scatters over processes by frame ranges with no pixel traffic
    between them.
    """
    nproc = process_count()
    if batch_global % nproc:
        raise ValueError(
            f"process count {nproc} must divide the global batch {batch_global} "
            f"(pick a batch that is a multiple of {nproc})"
        )
    per = batch_global // nproc
    pid = process_index()
    return pid * per, (pid + 1) * per


def multihost_roundtrip(mesh: Mesh, frames_local: np.ndarray,
                        payload_local: np.ndarray, total_bits: int,
                        delta: float, num_ac: int,
                        kernel: str = "xla"):
    """Full sharded embed->extract->global-BER step across processes.

    frames_local: (B_local, H, W) — this process's slice of the global batch
    (see host_batch_slice). payload_local: (B_local, C) matching bit
    columns. Returns (stego_local, extracted_local, bits_per_frame_local,
    total_errors) where *_local are this process's rows (numpy) and
    total_errors is the payload-slot error count summed over every process
    (identical on all of them).
    """
    from stegotpu_torch.parallel.mesh import sharded_roundtrip_step

    step = sharded_roundtrip_step(mesh, num_ac, kernel=kernel)
    stego, bpf, extracted, errors = step(
        torch.from_numpy(np.ascontiguousarray(frames_local)),
        torch.from_numpy(np.ascontiguousarray(payload_local)),
        total_bits, delta)
    return (stego.cpu().numpy(), extracted.cpu().numpy(), bpf.cpu().numpy(),
            int(errors))


def _dryrun_worker(process_id: int, num_processes: int, port: int,
                   n_space: int, device=None,
                   host_devices: int | None = None) -> None:
    """One process of the multi-process dryrun (spawned by the test).

    Builds the global mesh, feeds only this process's frame slice
    (generated deterministically from the global seed — standing in for
    'each process decodes its own frame range'), runs the sharded round
    trip, and verifies BER=0 both via the global sum and against the local
    payload shard.
    """
    initialize(f"127.0.0.1:{port}", num_processes, process_id)
    try:
        mesh = global_mesh(n_space=n_space,
                           devices=local_devices(device, host_devices))
        n_data = mesh.shape["data"]

        num_ac, delta = 10, 20.0
        b_global, h, w = 2 * n_data, 8 * 2 * n_space, 64
        cap = (h // 8) * (w // 8) * num_ac
        rng = np.random.default_rng(7)  # same global stream everywhere
        frames_all = rng.integers(60, 196, (b_global, h, w), dtype=np.uint8)
        payload_all = rng.integers(0, 2, (b_global, cap), dtype=np.uint8)
        total_bits = b_global * cap - 5  # payload ends mid-block on purpose
        lo, hi = host_batch_slice(mesh, b_global)

        stego_l, extracted_l, bpf_l, errors = multihost_roundtrip(
            mesh, frames_all[lo:hi], payload_all[lo:hi], total_bits, delta,
            num_ac, kernel="pallas")
        if errors != 0:
            raise RuntimeError(f"global BER != 0: {errors} errors")
        # local re-check against the process's own payload shard (masked to
        # the slots that actually carry payload)
        flat = extracted_l.reshape(-1)
        want = payload_all[lo:hi].reshape(-1)
        valid = (np.arange(flat.size) + lo * cap) < total_bits
        if not (flat[valid] == want[valid]).all():
            raise RuntimeError("local shard mismatch")
        if bpf_l.sum() != min(total_bits, hi * cap) - lo * cap:
            raise RuntimeError(f"bits per frame {bpf_l.tolist()} wrong")
        if stego_l.shape != (hi - lo, h, w):
            raise RuntimeError(f"stego shape {stego_l.shape}")
        print(f"MULTIHOST_OK pid={process_id}/{num_processes} "
              f"mesh=data:{n_data},space:{n_space} "
              f"devices={mesh.devices.size} errors={errors}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="multi-process dryrun worker (one process of N)")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--space", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA cards)")
    ap.add_argument("--host-devices", type=int, default=None, metavar="N",
                    help="with --device cpu: N CPU devices per process")
    a = ap.parse_args(argv)
    _dryrun_worker(a.process_id, a.num_processes, a.port, a.space, a.device,
                   a.host_devices)


if __name__ == "__main__":
    main()
