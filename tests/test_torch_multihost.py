"""The port's multi-process sharded round trip over torch.distributed +
Gloo, case for case against tests/test_multihost.py.

Spawns two CPU processes with 4 CPU devices each (`--device cpu
--host-devices 4`), forms one process-major 8-device ('data', 'space') mesh
across them (stegotpu_torch.parallel.distributed.global_mesh), and runs the
sharded embed -> extract -> error count step with each process feeding only
its own frame slice; the error count is all-reduced over the processes.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(pid: int, nproc: int, port: int, space: int):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "stegotpu_torch.parallel.distributed",
         "--process-id", str(pid), "--num-processes", str(nproc),
         "--port", str(port), "--space", str(space), "--device", "cpu",
         "--host-devices", "4"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.parametrize("space", [1, 2])
def test_two_process_roundtrip(space):
    port = _free_port()
    procs = [_spawn(pid, 2, port, space) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("multi-process worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK pid={pid}/2" in out, out
        assert f"mesh=data:{8 // space},space:{space} devices=8" in out, out
        assert "errors=0" in out


def test_host_batch_slice_matches_jax(monkeypatch):
    """host_batch_slice gives the JAX package's slices and its error for a
    process count that does not divide the batch; outside a group it is
    one process (jax.process_count() == 1 without jax.distributed)."""
    import jax
    import torch

    from stegotpu.parallel import distributed as jdist
    from stegotpu_torch.parallel import distributed as tdist
    from stegotpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 1, [torch.device("cpu")] * 2)
    assert tdist.host_batch_slice(mesh, 8) == jdist.host_batch_slice(None, 8)
    for nproc, pid, batch in ((2, 1, 8), (4, 3, 16), (3, 0, 8)):
        monkeypatch.setattr(tdist, "process_count", lambda: nproc)
        monkeypatch.setattr(tdist, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        try:
            want = jdist.host_batch_slice(None, batch)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tdist.host_batch_slice(mesh, batch)
            assert str(got.value) == str(e)
        else:
            assert tdist.host_batch_slice(mesh, batch) == want


def test_global_mesh_outside_a_group_is_local():
    """One process (no group): the global mesh is the local one, owning
    every 'data' row, and refuses devices that 'space' does not divide."""
    import torch

    from stegotpu_torch.parallel.distributed import global_mesh

    mesh = global_mesh(n_space=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 2, "space": 2}
    assert mesh.data_rows == range(2) and not mesh.spans_processes
    with pytest.raises(ValueError, match="multiple of space=3"):
        global_mesh(n_space=3, devices=[torch.device("cpu")] * 4)
