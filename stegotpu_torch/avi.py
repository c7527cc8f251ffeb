"""The AVI container of the cv2 writer's encoder lanes.

``video.VideoWriter`` encodes runs of frames on several threads, each run
into a separate AVI file written by cv2. This module reads the packets of
such a file (``read_lane``) and writes the packets of all of them, in frame
order, into one AVI (``AviJoiner``), laid out as libavformat's AVI muxer
(libavformat/avienc.c) lays out its own files:

- the first lane file's header up to its ``LIST movi``, copied unchanged
  (the FFV1 extradata in ``strf`` and the reserved ``JUNK`` included), with
  the frame counts (``avih`` total frames, ``strh`` length) and ``strh``'s
  suggested buffer size (the largest packet) patched at the end;
- one ``LIST movi`` of ``00dc`` packets, each padded to an even size;
- an ``idx1`` whose keyframe flags are those of the lane files' own
  indexes, so each run's first frame is a keyframe.

Past ``RIFF_LIMIT`` bytes in one RIFF (AVI 1.0's 1 GiB) the file goes on
in OpenDML form as libavformat's does: a ``ix00`` standard index at the end
of each ``movi``, the ``idx1`` of the first RIFF only, further
``RIFF AVIX`` pieces, the super index written into the ``JUNK`` that the
header reserves in ``strl`` (renamed ``indx``), and the ``JUNK`` that holds
``odml``/``dmlh`` renamed ``LIST`` with the total frame count.

Nothing here decodes or encodes: packets are copied byte for byte.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

# AVI_MAX_RIFF_SIZE of libavformat/avi.h: a RIFF grows past it only by the
# packet that crosses it; read at call time (the tests lower it)
RIFF_LIMIT = 1 << 30

_KEY = 0x10           # AVIIF_KEYFRAME in idx1
_NOT_KEY = 0x80000000  # the high bit of an ix00 entry's size: not a keyframe
_U32 = struct.Struct("<I")


@dataclass(frozen=True)
class Header:
    """Offsets (from the file's start) of the header fields the joiner
    patches; the same in every lane file and in the joined file."""

    total_frames: int      # avih dwTotalFrames
    length: int            # strh dwLength
    buffer_size: int       # strh dwSuggestedBufferSize
    indx: int | None       # the super index's JUNK or indx (its tag)
    indx_entries: int      # super index entries it has room for
    odml: int | None       # the JUNK or LIST that holds odml/dmlh (its tag)


@dataclass(frozen=True)
class Lane:
    """One lane file: its header up to ``LIST movi``, and its packets as
    (offset, size) into ``data`` with their keyframe flags."""

    prefix: bytes
    header: Header
    data: memoryview
    packets: list[tuple[int, int]]
    keys: list[bool]


def _chunks(b: bytes, a: int, end: int):
    """(tag, data offset, size) of the RIFF chunks in b[a:end]."""
    while a + 8 <= end:
        size = _U32.unpack_from(b, a + 4)[0]
        if a + 8 + size > end:
            raise IOError(f"AVI chunk {bytes(b[a:a + 4])!r} at {a} runs past "
                          f"its parent ({a + 8 + size} > {end})")
        yield bytes(b[a:a + 4]), a + 8, size
        a += 8 + size + (size & 1)


def _header(b: bytes, hdrl: int, end: int) -> Header:
    total = length = bufsize = None
    indx, entries, odml = None, 0, None
    for tag, at, size in _chunks(b, hdrl, end):
        if tag == b"avih":
            if _U32.unpack_from(b, at + 24)[0] != 1:
                raise IOError("lane file holds more than one stream")
            total = at + 16
        elif tag == b"LIST" and b[at:at + 4] == b"strl":
            for t2, a2, s2 in _chunks(b, at + 4, at + size):
                if t2 == b"strh":
                    if b[a2:a2 + 4] != b"vids":
                        raise IOError("lane file's stream is not video")
                    length, bufsize = a2 + 32, a2 + 36
                elif (t2 in (b"JUNK", b"indx") and s2 >= 24
                      and b[a2:a2 + 4] == b"\x04\0\0\0"):
                    indx, entries = a2 - 8, (s2 - 24) // 16
        elif tag in (b"JUNK", b"LIST") and b[at:at + 8] == b"odmldmlh":
            odml = at - 8
    if total is None or length is None:
        raise IOError("lane file has no avih or strh")
    return Header(total, length, bufsize, indx, entries, odml)


def read_lane(path: str | Path) -> Lane:
    """The header and packets of an AVI that cv2's FFV1 writer made.

    Raises IOError for a file that is not one complete RIFF AVI with an
    idx1 covering each packet (a lane that did not finish)."""
    b = Path(path).read_bytes()
    if len(b) < 12 or b[:4] != b"RIFF" or b[8:12] != b"AVI ":
        raise IOError(f"'{path}' is not an AVI file")
    end = 8 + _U32.unpack_from(b, 4)[0]
    if not 0 <= len(b) - end <= 1:
        raise IOError(f"'{path}': RIFF size {end - 8} does not match the "
                      f"file ({len(b)} bytes)")
    header = movi = movi_end = idx1 = None
    for tag, at, size in _chunks(b, 12, end):
        if tag == b"LIST" and b[at:at + 4] == b"hdrl":
            header = _header(b, at + 4, at + size)
        elif tag == b"LIST" and b[at:at + 4] == b"movi":
            movi, movi_end = at, at + size
        elif tag == b"idx1":
            idx1 = (at, size)
    if header is None or movi is None or idx1 is None:
        raise IOError(f"'{path}' lacks hdrl, movi or idx1")
    packets = [(at, size) for tag, at, size in _chunks(b, movi + 4, movi_end)
               if tag[:2] == b"00" and tag[2:] in (b"dc", b"db")]
    at, size = idx1
    flags = {}
    for e in range(at, at + size - 15, 16):
        if b[e:e + 2] == b"00":
            flags[_U32.unpack_from(b, e + 8)[0]] = \
                bool(_U32.unpack_from(b, e + 4)[0] & _KEY)
    try:
        keys = [flags[p - 8 - movi] for p, _ in packets]
    except KeyError:
        raise IOError(f"'{path}': idx1 does not cover every packet") from None
    return Lane(b[:movi - 8], header, memoryview(b), packets, keys)


def _blank(prefix: bytes, h: Header) -> bytes:
    """The prefix with the fields the joiner writes zeroed (the RIFF's
    size, the counts, the buffer size)."""
    out = bytearray(prefix)
    for at in (4, h.total_frames, h.length, h.buffer_size):
        out[at:at + 4] = b"\0\0\0\0"
    return bytes(out)


class AviJoiner:
    """Writes lanes' packets, in the order added, into one AVI at `path`.

    The file is created by the first ``add``; ``finish`` writes the index
    and the counts. Lanes must come from writers with the same settings:
    a header that differs beyond the patched fields raises IOError."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.frames = 0
        self._f = None
        self._h: Header | None = None
        self._blank = b""
        self._max = 0
        self._riff_id = 0
        self._riff_start = self._movi = 0
        self._entries: list[tuple[int, int, bool]] = []  # this RIFF's

    # --- RIFF writing, as libavformat's ff_start_tag / ff_end_tag -----------

    def _start_tag(self, tag: bytes) -> int:
        self._f.write(tag + b"\xff\xff\xff\xff")
        return self._f.tell()

    def _end_tag(self, start: int) -> None:
        f = self._f
        pos = f.tell()
        if pos & 1:
            f.write(b"\0")
        f.seek(start - 4)
        f.write(_U32.pack((pos - start) & 0xFFFFFFFF))
        f.seek(pos + (pos & 1))

    def _patch(self, at: int, data: bytes) -> None:
        f = self._f
        pos = f.tell()
        f.seek(at)
        f.write(data)
        f.seek(pos)

    def _new_riff(self) -> None:
        """Start a RIFF AVIX piece and its movi (avi_start_new_riff)."""
        self._riff_id += 1
        self._entries = []
        self._riff_start = self._start_tag(b"RIFF")
        self._f.write(b"AVIX")
        self._movi = self._start_tag(b"LIST")
        self._f.write(b"movi")

    def _write_idx1(self) -> None:
        start = self._start_tag(b"idx1")
        self._f.write(b"".join(
            b"00dc" + struct.pack("<III", _KEY if key else 0, pos, size)
            for pos, size, key in self._entries))
        self._end_tag(start)
        self._patch(self._h.total_frames, _U32.pack(self.frames))
        self._patch(self._h.length, _U32.pack(self.frames))

    def _write_ix(self) -> None:
        """This RIFF's ix00 standard index, and its super index entry."""
        h = self._h
        if h.indx is None or self._riff_id > h.indx_entries:
            raise IOError(
                f"'{self.path}': past {h.indx_entries} RIFFs the AVI's "
                "reserved super index is full")
        n = len(self._entries)
        ix = self._f.tell()
        self._f.write(b"ix00" + struct.pack("<IHBBI", 24 + 8 * n, 2, 0, 1, n)
                      + b"00dc" + struct.pack("<QI", self._movi, 0))
        self._f.write(b"".join(
            struct.pack("<II", pos + 8, size | (0 if key else _NOT_KEY))
            for pos, size, key in self._entries))
        size = self._f.tell() - ix
        self._patch(h.indx, b"indx")
        self._patch(h.indx + 12, _U32.pack(self._riff_id))
        self._patch(h.indx + 32 + 16 * (self._riff_id - 1),
                    struct.pack("<QII", ix, size, n))

    # --- the lanes ---------------------------------------------------------

    def add(self, lane: Lane) -> None:
        """Append a lane's packets, as one run of frames."""
        if self._f is None:
            self._h = lane.header
            self._blank = _blank(lane.prefix, lane.header)
            self._f = open(self.path, "wb")
            self._f.write(lane.prefix)
            self._riff_id = 1
            self._riff_start = 8
            self._movi = self._start_tag(b"LIST")
            self._f.write(b"movi")
        elif lane.header != self._h or _blank(lane.prefix,
                                              lane.header) != self._blank:
            raise IOError(f"'{self.path}': a lane's AVI header differs from "
                          "the first lane's")
        f, limit = self._f, RIFF_LIMIT
        for (at, size), key in zip(lane.packets, lane.keys):
            pos = f.tell()
            if pos - self._riff_start > limit:
                self._write_ix()
                self._end_tag(self._movi)
                if self._riff_id == 1:
                    self._write_idx1()
                self._end_tag(self._riff_start)
                self._new_riff()
                pos = f.tell()
            self._entries.append((pos - self._movi, size, key))
            f.write(b"00dc" + _U32.pack(size))
            f.write(lane.data[at:at + size])
            if size & 1:
                f.write(b"\0")
            self._max = max(self._max, size)
            self.frames += 1

    def finish(self) -> None:
        """Write the index and the counts, and close the file."""
        if self._f is None:
            return
        h = self._h
        if self._riff_id == 1:
            self._end_tag(self._movi)
            self._write_idx1()
            self._end_tag(self._riff_start)
        else:
            self._write_ix()
            self._end_tag(self._movi)
            self._end_tag(self._riff_start)
            if h.odml is None:
                raise IOError(f"'{self.path}': the AVI header reserves no "
                              "odml list")
            self._patch(h.odml, b"LIST")
            self._patch(h.odml + 20, _U32.pack(self.frames))
            self._patch(h.length, _U32.pack(self.frames))
        self._patch(h.buffer_size, _U32.pack(self._max))
        self.close()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
