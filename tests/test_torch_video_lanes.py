"""The cv2 FFV1 writer's encoder lanes (stegotpu_torch/video.py) and the AVI
they are joined into (stegotpu_torch/avi.py), on small frames.

`effective_cpu_count` is patched so that `encoder_lanes()` gives L: 1 is
the single cv2.VideoWriter of before, 2 and 4 are pools of lanes.
"""

import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from stegotpu_torch import avi, video
from stegotpu_torch.native import videoio as native_io
from stegotpu_torch.utils.profiling import StageTimer

H, W = 48, 64
FOURCC = cv2.VideoWriter_fourcc(*"FFV1")
needs_native = pytest.mark.skipif(
    not native_io.available(),
    reason=f"native lib unavailable: {native_io.build_error()}")


@pytest.fixture
def lanes(monkeypatch):
    def set_lanes(n: int) -> None:
        monkeypatch.setattr(video, "effective_cpu_count", lambda: n + 2)
        assert video.encoder_lanes() == n
    return set_lanes


def _runs(n: int, seed: int = 0):
    """n frames as runs of gray and BGR frames, mixed: [(gray, frames)]."""
    rng = np.random.default_rng(seed)
    runs, sizes, a, gray = [], [3, 1, 5, 2, 8, 4, 6], 0, True
    while a < n:
        k = min(sizes[len(runs) % len(sizes)], n - a)
        shape = (k, H, W) if gray else (k, H, W, 3)
        runs.append((gray, rng.integers(0, 256, shape, np.uint8)))
        a, gray = a + k, not gray
    return runs


def _bgr(gray: bool, frames: np.ndarray) -> np.ndarray:
    return np.repeat(frames[..., None], 3, axis=-1) if gray else frames


def _expected(runs) -> np.ndarray:
    return np.concatenate([_bgr(g, f) for g, f in runs])


def _write(path, runs, **kw) -> None:
    with video.VideoWriter(path, 24.0, W, H, backend="cv2", **kw) as w:
        for gray, frames in runs:
            (w.write_gray_batch if gray else w.write_bgr_batch)(frames)


def _serial(path, frames: np.ndarray) -> None:
    """What one cv2.VideoWriter writes for the frames."""
    out = cv2.VideoWriter(str(path), FOURCC, 24.0, (W, H), isColor=True)
    for f in frames:
        out.write(np.ascontiguousarray(f))
    out.release()


def _decode(path) -> tuple[np.ndarray, int]:
    cap = cv2.VideoCapture(str(path))
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, H, W, 3)), count


def _packets(path) -> tuple[list[bytes], list[bool]]:
    lane = avi.read_lane(path)
    return [bytes(lane.data[a:a + n]) for a, n in lane.packets], lane.keys


def _lane_dirs(d: Path) -> list[Path]:
    return list(d.glob(".*.lanes-*"))


@pytest.mark.parametrize("n, lanes, longest, shortest, expected", [
    (8, 7, 12, 1, [2, 2, 2, 2]),
    (7, 7, 12, 1, [1] * 7),
    (25, 4, 12, 1, [7, 6, 6, 6]),
    (100, 7, 12, 1, [12] + [11] * 8),
    (24, 2, 12, 1, [12, 12]),
    (1, 4, 12, 1, [1]),
    (5, 4, 1, 1, [1] * 5),
    (0, 4, 12, 1, []),
    (8, 7, 12, 4, [4, 4]),
    (7, 7, 12, 4, [4, 3]),
    (1, 7, 12, 4, [1]),
    (25, 4, 12, 4, [7, 6, 6, 6]),
    (9, 7, 12, 3, [3, 3, 3]),
    (30, 2, 12, 20, [10, 10, 10]),
])
def test_lane_chunks(n, lanes, longest, shortest, expected):
    assert video.lane_chunks(n, lanes, longest, shortest) == expected
    assert sum(expected) == n
    if shortest == 1:
        assert video.lane_chunks(n, lanes, longest) == expected


def _starts(runs, n_lanes: int) -> list[int]:
    """The first frame of every run that the writes are cut into."""
    starts, a = [], 0
    for _, frames in runs:
        for size in video.lane_chunks(len(frames), n_lanes, video.KEY_INTERVAL,
                                      video.MIN_RUN):
            starts.append(a)
            a += size
    return starts


def test_cv2_ffv1_starts_a_keyframe_every_12_frames(tmp_path):
    """A lane's run of at most KEY_INTERVAL frames holds one keyframe, its
    first: what the lanes' runs rest on."""
    frames = _expected(_runs(30))
    _serial(tmp_path / "s.avi", frames)
    _, keys = _packets(tmp_path / "s.avi")
    assert video.KEY_INTERVAL == 12
    assert [i for i, k in enumerate(keys) if k] == [0, 12, 24]


@pytest.mark.parametrize("n", [1, 7, 8, 13, 25])
@pytest.mark.parametrize("n_lanes", [1, 2, 4])
def test_every_frame_decodes_as_written(tmp_path, lanes, n_lanes, n):
    lanes(n_lanes)
    runs = _runs(n, seed=n)
    _write(tmp_path / "o.avi", runs)
    got, count = _decode(tmp_path / "o.avi")
    assert count == n
    np.testing.assert_array_equal(got, _expected(runs))
    assert _lane_dirs(tmp_path) == []


@pytest.mark.parametrize("n_lanes", [2, 4])
def test_each_run_is_a_lone_writers_packets(tmp_path, lanes, n_lanes):
    """Each run (the frames from one keyframe to the next) holds the
    packets of a fresh cv2 writer over its frames, exactly its first a
    keyframe; runs of at most 12 frames, split where the writes split, one
    counted in ENCODE_CHUNKS each."""
    lanes(n_lanes)
    runs = _runs(25, seed=3)
    before = video.ENCODE_CHUNKS["lane"]
    _write(tmp_path / "o.avi", runs)
    got, keys = _packets(tmp_path / "o.avi")
    starts = [i for i, key in enumerate(keys) if key] + [len(keys)]
    assert video.ENCODE_CHUNKS["lane"] - before == len(starts) - 1
    assert starts[:-1] == _starts(runs, n_lanes)
    frames = _expected(runs)
    for a, b in zip(starts, starts[1:]):
        assert 1 <= b - a <= 12
        _serial(tmp_path / "lone.avi", frames[a:b])
        assert _packets(tmp_path / "lone.avi") == (got[a:b],
                                                   [True] + [False] * (b - a - 1))


def test_one_lane_is_the_single_writer_byte_for_byte(tmp_path, lanes):
    lanes(1)
    runs = _runs(25, seed=5)
    _write(tmp_path / "o.avi", runs)
    _serial(tmp_path / "s.avi", _expected(runs))
    assert (tmp_path / "o.avi").read_bytes() == (tmp_path / "s.avi").read_bytes()
    assert _lane_dirs(tmp_path) == []


@pytest.mark.parametrize("n_lanes, n", [(2, 24), (3, 36)])
def test_runs_on_the_keyframes_give_the_single_writers_file(tmp_path, lanes,
                                                            n_lanes, n):
    """Runs of exactly 12 frames are the serial file's stretches between
    keyframes, so the joined file is the serial file, header and index."""
    lanes(n_lanes)
    frames = np.random.default_rng(n).integers(0, 256, (n, H, W, 3), np.uint8)
    _write(tmp_path / "o.avi", [(False, frames)])
    _serial(tmp_path / "s.avi", frames)
    assert (tmp_path / "o.avi").read_bytes() == (tmp_path / "s.avi").read_bytes()


def test_an_empty_writer_leaves_the_single_writers_empty_file(tmp_path, lanes):
    lanes(4)
    _write(tmp_path / "o.avi", [])
    _serial(tmp_path / "s.avi", [])
    assert (tmp_path / "o.avi").read_bytes() == (tmp_path / "s.avi").read_bytes()
    assert _lane_dirs(tmp_path) == []


@pytest.mark.parametrize("backend", [
    "cv2", pytest.param("native", marks=needs_native)])
@pytest.mark.parametrize("n_lanes", [1, 4])
def test_seek_to_a_frame_that_is_not_a_keyframe(tmp_path, lanes, n_lanes,
                                                backend):
    lanes(n_lanes)
    runs = _runs(25, seed=7)
    _write(tmp_path / "o.avi", runs)
    want = _expected(runs)
    _, keys = _packets(tmp_path / "o.avi")
    targets = [i for i, key in enumerate(keys) if not key]
    assert len(targets) >= 3
    for target in targets:
        with video.VideoReader(tmp_path / "o.avi", backend=backend) as r:
            r.seek(target)
            np.testing.assert_array_equal(r.read_frame(), want[target])


@pytest.mark.parametrize("fault", ["raises", "drops_a_frame", "last_run"])
def test_a_lane_failure_raises_and_leaves_no_temporary_files(
        tmp_path, lanes, monkeypatch, fault):
    lanes(4)
    real = video._Lanes._encode
    calls = []

    def encode(self, frames, gray, path):
        calls.append(path)
        if fault == "raises" and len(calls) == 2:
            raise IOError("lane encoder failed")
        if fault == "drops_a_frame" and len(calls) == 3:
            frames = frames[1:]
        if fault == "last_run" and len(frames) == 1 and not gray:
            raise IOError("lane encoder failed")
        real(self, frames, gray, path)

    monkeypatch.setattr(video._Lanes, "_encode", encode)
    runs = [(False, _bgr(g, f)) for g, f in _runs(20, seed=9)] + \
        [(False, np.zeros((1, H, W, 3), np.uint8))]
    with pytest.raises(IOError, match=r"lane encoder failed|lane wrote \d+ of \d+ frames"):
        _write(tmp_path / "o.avi", runs)
    assert _lane_dirs(tmp_path) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["o.avi"]


def test_a_lane_error_is_raised_by_the_next_write(tmp_path, lanes,
                                                  monkeypatch):
    lanes(2)

    def encode(self, frames, gray, path):
        raise IOError("lane encoder failed")

    monkeypatch.setattr(video._Lanes, "_encode", encode)
    w = video.VideoWriter(tmp_path / "o.avi", 24.0, W, H, backend="cv2")
    frames = np.zeros((2, H, W, 3), np.uint8)
    w.write_bgr_batch(frames)
    deadline = time.monotonic() + 10
    while w._lanes.error is None and time.monotonic() < deadline:
        time.sleep(0.01)  # the joiner thread meets the error on its own
    with pytest.raises(IOError, match="lane encoder failed"):
        w.write_bgr_batch(frames)
    with pytest.raises(IOError, match="lane encoder failed"):
        w.release()
    assert _lane_dirs(tmp_path) == []


@pytest.mark.parametrize("backend", [
    "cv2", pytest.param("native", marks=needs_native)])
def test_past_the_riff_limit_the_file_goes_on_as_opendml(tmp_path, lanes,
                                                         monkeypatch,
                                                         backend):
    """With the 1 GiB RIFF limit lowered to 64 KiB, 40 frames of ~12 KB
    fill 8 RIFFs: an AVI one, then AVIX pieces, indexed by ix00 chunks
    under the header's indx, with the total in odml/dmlh."""
    lanes(4)
    monkeypatch.setattr(avi, "RIFF_LIMIT", 64 << 10)
    runs = [(False, _bgr(g, f)) for g, f in _runs(40, seed=11)]
    _write(tmp_path / "o.avi", runs)
    want = _expected(runs)
    got, count = _decode(tmp_path / "o.avi")
    assert count == 40
    np.testing.assert_array_equal(got, want)
    b = (tmp_path / "o.avi").read_bytes()
    riffs, a = [], 0
    while a < len(b):
        riffs.append(b[a + 8:a + 12])
        a += 8 + int.from_bytes(b[a + 4:a + 8], "little")
    assert riffs[0] == b"AVI " and set(riffs[1:]) == {b"AVIX"}
    assert len(riffs) > 2
    hdrl = b.index(b"hdrl") + 4
    hdr = avi._header(b, hdrl,
                      hdrl + int.from_bytes(b[hdrl - 8:hdrl - 4], "little") - 4)
    assert b[hdr.indx:hdr.indx + 4] == b"indx"
    assert int.from_bytes(b[hdr.indx + 12:hdr.indx + 16], "little") == len(riffs)
    assert b[hdr.odml:hdr.odml + 4] == b"LIST"
    assert int.from_bytes(b[hdr.odml + 20:hdr.odml + 24], "little") == 40
    assert b.count(b"ix00") == len(riffs)
    with video.VideoReader(tmp_path / "o.avi", backend=backend) as r:
        assert r.info.frame_count == 40
        r.seek(33)
        np.testing.assert_array_equal(r.read_frame(), want[33])


def test_a_full_super_index_raises_and_leaves_no_temporary_files(
        tmp_path, lanes, monkeypatch):
    """Every packet past the limit opens a RIFF: 258 of them overflow the
    256 super index entries the header reserves."""
    lanes(2)
    monkeypatch.setattr(avi, "RIFF_LIMIT", 0)
    frames = np.zeros((258, H, W, 3), np.uint8)
    with pytest.raises(IOError, match="super index is full"):
        _write(tmp_path / "o.avi", [(False, frames)])
    assert _lane_dirs(tmp_path) == []


def test_encode_chunks_counts_lane_runs_and_serial_frames(tmp_path, lanes):
    lanes(4)
    before = video.ENCODE_CHUNKS.copy()
    runs = [(False, np.zeros((8, H, W, 3), np.uint8)),
            (True, np.zeros((1, H, W), np.uint8)),
            (True, np.zeros((13, H, W), np.uint8))]
    _write(tmp_path / "a.avi", runs)
    _, keys = _packets(tmp_path / "a.avi")
    assert video.ENCODE_CHUNKS - before == {"lane": sum(keys)}
    # 8 frames on 4 lanes, then 1, then 13: runs as lane_chunks cuts them
    assert sum(keys) == len(_starts(runs, 4))
    lane = sum(keys)
    with video.VideoWriter(tmp_path / "h.avi", 24.0, W, H, "HFYU",
                           backend="cv2") as w:  # HFYU: one writer
        w.write_bgr_batch(runs[0][1])
    assert video.ENCODE_CHUNKS - before == {"lane": lane, "serial": 8}
    lanes(1)
    _write(tmp_path / "b.avi", runs)
    assert video.ENCODE_CHUNKS - before == {"lane": lane, "serial": 30}
    assert _lane_dirs(tmp_path) == []


def test_lanes_time_their_work_and_release_its_wait(tmp_path, lanes):
    lanes(2)
    timer = StageTimer()
    _write(tmp_path / "o.avi", _runs(13), timer=timer)
    _, keys = _packets(tmp_path / "o.avi")
    # each run encoded, then joined, under encode_lane; the wait under encode
    assert timer.counts["encode_lane"] == 2 * sum(keys)
    assert timer.counts["encode"] == 1 and timer.totals["encode"] >= 0


@pytest.mark.parametrize("n_lanes", [2, 4])
def test_the_same_writes_give_the_same_file_however_the_lanes_run(
        tmp_path, lanes, monkeypatch, n_lanes):
    """Lanes slowed at random, differently in each writer, finish their
    runs in other orders and while other writes wait: the files are equal
    byte for byte, and equal to the lanes' file at full speed."""
    lanes(n_lanes)
    runs = _runs(40, seed=13)
    _write(tmp_path / "fast.avi", runs)
    real = video._Lanes._encode

    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        delays = iter(rng.uniform(0, 0.03, 64))

        def encode(self, frames, gray, path, delays=delays):
            time.sleep(next(delays))
            real(self, frames, gray, path)

        monkeypatch.setattr(video._Lanes, "_encode", encode)
        _write(tmp_path / f"slow{seed}.avi", runs)
    fast = (tmp_path / "fast.avi").read_bytes()
    assert (tmp_path / "slow1.avi").read_bytes() == fast
    assert (tmp_path / "slow2.avi").read_bytes() == fast
    got, _ = _decode(tmp_path / "slow1.avi")
    np.testing.assert_array_equal(got, _expected(runs))


def test_threads_sharing_a_stage_timer_lose_no_sum():
    """The lanes and the joiner time encode_lane on several threads at
    once; the timer's sums are taken under one lock."""
    timer, lock = StageTimer(), video.threading.Lock()

    def stages():
        for _ in range(2000):
            with video._shared_stage(timer, "encode_lane", lock):
                pass

    threads = [video.threading.Thread(target=stages) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timer.counts["encode_lane"] == 8000
    with pytest.raises(KeyError):
        with video._shared_stage(timer, "encode_lane", lock):
            raise KeyError("raised inside the stage")
    assert timer.counts["encode_lane"] == 8001
    with video._shared_stage(None, "encode_lane", lock):
        pass


@needs_native
def test_lane_segments_stream_copy_into_one_file(tmp_path, lanes):
    """The multi-process embed's stitch: native concat of two lane-written
    segments decodes to both segments' frames."""
    lanes(4)
    a, b = _runs(13, seed=1), _runs(8, seed=2)
    _write(tmp_path / "a.avi", a)
    _write(tmp_path / "b.avi", b)
    native_io.concat_videos(tmp_path / "ab.avi",
                            [tmp_path / "a.avi", tmp_path / "b.avi"])
    got, count = _decode(tmp_path / "ab.avi")
    assert count == 21
    np.testing.assert_array_equal(got, np.concatenate([_expected(a),
                                                       _expected(b)]))
