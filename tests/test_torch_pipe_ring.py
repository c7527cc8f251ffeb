"""K13's tile walk and ring, mirrored in Python.

``qim_roundtrip_pipe_kernel`` (stegotpu_torch/csrc/qim_pipe.cu) is a
persistent kernel: CTA c of a grid of G walks the tiles t = (f * bh + by) *
chunks + cx from t = c with a stride of G (``TileWalk``: one decomposition,
then two carries a step), and streams them through a ring of BUFS
shared-memory slots that every thread fills with cp.async, BUFS-1 tiles
ahead, one commit group a tile, ``wait_group<BUFS-1>`` and a barrier before
a tile is read, a barrier after. Neither runs on the CPU, so this file
mirrors both, line for line, and holds the mirror to the source text:

- over grids of 1 to 1,056 CTAs and shapes with partial column chunks
  (W = 8 * (128k + r)), every tile is computed exactly once, the walk's
  carries equal divmod, and each frame's bits per frame have exactly one
  writer (thread 0 of the tile at block row 0, chunk 0);
- the ring, run by a random scheduler for a CTA of 0 to 70 tiles at BUFS
  2, 3 and 4, its copies landing in any order: no slot is refilled before
  every thread is done with its tile, no thread reads a slot before every
  thread's copies of its tile have landed, and the ring drains (a CTA
  with fewer tiles than BUFS - 1 included).

No JAX and no card: ``python -m pytest tests/test_torch_pipe_ring.py -q``.
"""

import random
import re
from pathlib import Path

import pytest

SRC = (Path(__file__).resolve().parents[1] / "stegotpu_torch" / "csrc"
       / "qim_pipe.cu").read_text()
THREADS = 128  # kThreads: blocks a tile


# --- the walk -------------------------------------------------------------------

def walk_start(t: int, bh: int, chunks: int) -> list[int]:
    """TileWalk::start: [f, by, cx] of tile t."""
    row = t // chunks
    cx = t - row * chunks
    f = row // bh
    return [f, row - f * bh, cx]


def walk_next(w: list[int], step: list[int], bh: int, chunks: int) -> None:
    """TileWalk::next: add the decomposed stride with two carries."""
    w[2] += step[2]
    c1 = int(w[2] >= chunks)
    w[2] -= chunks if c1 else 0
    w[1] += step[1] + c1
    c2 = int(w[1] >= bh)
    w[1] -= bh if c2 else 0
    w[0] += step[0] + c2


def test_mirror_follows_the_source():
    walk = SRC[SRC.index("struct TileWalk {"):SRC.index("};", SRC.index(
        "struct TileWalk {"))]
    for line in ("const int row = t / chunks;", "cx = t - row * chunks;",
                 "f = row / bh;", "by = row - f * bh;", "cx += step.cx;",
                 "const int c1 = cx >= chunks;", "cx -= c1 ? chunks : 0;",
                 "by += step.by + c1;", "const int c2 = by >= bh;",
                 "by -= c2 ? bh : 0;", "f += step.f + c2;"):
        assert line in walk, line
    body = SRC[SRC.index("\nqim_roundtrip_pipe_kernel("):]
    body = body[:body.index("\n}\n")]
    for line in ("step.start(gridDim.x, bh, chunks);",
                 "ahead.start(blockIdx.x, bh, chunks);",
                 "t.start(blockIdx.x, bh, chunks);",
                 "const int chunks = (bw + kThreads - 1) / kThreads;",
                 "if (t.by == 0 && t.cx == 0 && threadIdx.x == 0)",
                 "for (int s = 0; s < BUFS - 1; ++s) {",
                 "    if (ahead.f < b) {\n      issue(ahead, s);",
                 "for (int s = 0, ps = BUFS - 1; t.f < b; t.next(step, bh, chunks))",
                 "    if (ahead.f < b) {  // into slot ps",
                 "      issue(ahead, ps);\n      ahead.next(step, bh, chunks);",
                 "    if (++ps == BUFS) ps = 0;\n    cp_async_commit();\n"
                 "    cp_async_wait<BUFS - 1>();",
                 "    __syncthreads();  // every thread is done with the slot "
                 "before its refill\n    if (++s == BUFS) s = 0;"):
        assert line in body, line
    # the loop's barriers: one after the wait, one after the compute
    loop = body[body.index("for (int s = 0, ps = BUFS - 1;"):]
    assert loop.count("__syncthreads();") == 2
    assert loop.index("cp_async_wait<BUFS - 1>();") < loop.index(
        "__syncthreads();") < loop.index("uint8_t* slot = ring + s * slot_bytes;")
    # the launch: no more CTAs than tiles
    assert "const unsigned grid = static_cast<unsigned>(tiles < resident ? " \
           "tiles : resident);" in SRC


# (B, H, W): W = 8 * (128k + r), partial chunks where r > 0; the last is
# 1080p at one frame (2 chunks of 128 + 112 blocks, 270 tiles)
WALK_SHAPES = [(3, 48, 8 * 131), (2, 40, 8 * 17), (5, 16, 8 * (256 + 42)),
               (7, 24, 8 * 170), (4, 8, 8 * 128), (1, 1080, 1920)]


@pytest.mark.parametrize("b,h,w", WALK_SHAPES)
def test_walk_computes_every_tile_once(b, h, w):
    bh, bw = h // 8, w // 8
    chunks = -(-bw // THREADS)
    tiles = b * bh * chunks
    for grid in sorted({min(g, tiles) for g in range(1, 1057)}):
        step = walk_start(grid, bh, chunks)
        seen = [0] * tiles
        writers = [0] * b
        for c in range(grid):
            t = walk_start(c, bh, chunks)
            lin = c
            while t[0] < b:
                f, by, cx = t
                assert [f, by, cx] == [lin // (bh * chunks),
                                       lin // chunks % bh, lin % chunks]
                assert 0 <= by < bh and 0 <= cx < chunks
                seen[lin] += 1
                writers[f] += by == 0 and cx == 0  # thread 0 of that tile
                walk_next(t, step, bh, chunks)
                lin += grid
            assert lin >= tiles  # the walk ends past the last tile
        assert seen == [1] * tiles, grid
        assert writers == [1] * b, grid


# --- the ring ---------------------------------------------------------------------

def run_ring(mine: int, bufs: int, threads: int, rng: random.Random,
             trailing_barrier: bool = True) -> list[list[int]]:
    """One CTA's ring over tiles 0..mine-1 as the kernel runs it, its
    threads interleaved at random and its copies landing in any order:
    each thread is a generator that yields the condition it waits on.
    Returns the tiles each thread read, in order."""
    holds = [[None] * threads for _ in range(bufs)]  # slot, thread's part
    reads = [0] * mine       # threads done with each tile
    flying = []              # [slot, thread, tile, group] of copies in flight
    groups = [0] * threads   # each thread's commit groups so far
    arrived = [0]            # arrivals at __syncthreads, all generations
    read = [[] for _ in range(threads)]

    def issue(i: int, tile: int, s: int):
        # a slot is refilled only after every thread is done with the
        # tile it held, the tile a ring earlier
        assert tile < bufs or reads[tile - bufs] == threads, \
            "refill before every thread is done"
        flying.append([s, i, tile, groups[i]])

    def barrier(gen: int):
        arrived[0] += 1
        return lambda: arrived[0] >= threads * (gen + 1)

    def landed(i: int, keep: int) -> bool:  # wait_group<keep> returns
        return not any(c[1] == i and c[3] < groups[i] - keep for c in flying)

    def thread(i: int):
        gen, ahead = 0, 0
        for s in range(bufs - 1):  # the prologue
            if ahead < mine:
                issue(i, ahead, s)
                ahead += 1
            groups[i] += 1  # cp_async_commit
        s, ps = 0, bufs - 1
        for tile in range(mine):
            if ahead < mine:
                issue(i, ahead, ps)
                ahead += 1
            ps = 0 if ps + 1 == bufs else ps + 1
            groups[i] += 1
            yield lambda: landed(i, bufs - 1)  # cp_async_wait<BUFS - 1>
            yield barrier(gen)
            gen += 1
            # every thread's part of the tile has landed in slot s
            assert holds[s] == [tile] * threads, "read before it landed"
            read[i].append(tile)
            reads[tile] += 1
            if trailing_barrier:
                yield barrier(gen)
                gen += 1
            s = 0 if s + 1 == bufs else s + 1

    actors = [[thread(i), None] for i in range(threads)]
    while actors or flying:
        ready = [a for a in actors if a[1] is None or a[1]()]
        if flying and (not ready or rng.random() < 0.5):
            s, i, tile, _ = flying.pop(rng.randrange(len(flying)))
            holds[s][i] = tile  # a copy lands
            continue
        assert ready, "deadlock: every thread waits"
        a = rng.choice(ready)
        try:
            a[1] = next(a[0])
        except StopIteration:
            actors.remove(a)
    return read


@pytest.mark.parametrize("bufs", [2, 3, 4])
def test_ring_hands_every_slot_over_in_order(bufs):
    rng = random.Random(bufs)
    for mine in [*range(0, 9), 17, 65, 70]:
        for threads in (1, 3, 4):
            read = run_ring(mine, bufs, threads, rng)
            assert read == [list(range(mine))] * threads


@pytest.mark.parametrize("bufs", [2, 3, 4])
def test_the_mirror_catches_a_missing_barrier(bufs):
    """Without the barrier that ends a tile's compute, a fast thread
    refills a slot that a slow thread still reads: the mirror's checks
    catch it."""
    rng = random.Random(100 + bufs)
    with pytest.raises(AssertionError, match="refill before|read before"):
        for _ in range(50):
            run_ring(12, bufs, 4, rng, trailing_barrier=False)
