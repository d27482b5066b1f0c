"""Minimal pure-Python OpenEXR codec for single-channel depth maps (a copy
of ``vipe_tpu/utils/exr.py``).

ViPE stores per-frame metric depth as fp16 EXR files with a single "Z"
channel inside a zip archive.  The codec needs neither OpenEXR nor an
EXR-capable OpenCV build:

  - write: scanline image, one HALF channel (default "Z"), compression NONE
    (the surrounding zip archive already deflates).  Readable by any
    conforming reader.
  - read: scanline images with NONE / ZIPS / ZIP compression, HALF or FLOAT
    channels.

Format reference: the OpenEXR file layout documentation (openexr.com,
"Technical Introduction to OpenEXR").  No code derived from the OpenEXR
library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {"uint": 0, "half": 1, "float": 2}
_NP_OF_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}

# compression ids (uint8 attribute value)
_C_NONE, _C_RLE, _C_ZIPS, _C_ZIP, _C_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {_C_NONE: 1, _C_ZIPS: 1, _C_ZIP: 16}


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(channels) -> bytes:
    out = b""
    for name, ptype in channels:
        out += name.encode() + b"\0"
        out += struct.pack("<i", _PIXELTYPE[ptype])
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\0"


def encode_exr(img: np.ndarray, channel: str = "Z") -> bytes:
    """Encode a (H, W) array as a single-HALF-channel scanline EXR
    (compression NONE).  Matches what ViPE writes per depth frame
    (io.py:256-266: header["channels"] = {"Z": HALF}) modulo compression."""
    img = np.ascontiguousarray(np.asarray(img, np.float16))
    assert img.ndim == 2, img.shape
    h, w = img.shape

    header = b""
    header += _attr("channels", "chlist", _chlist([(channel, "half")]))
    header += _attr("compression", "compression", struct.pack("<B", _C_NONE))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    prefix = struct.pack("<ii", _MAGIC, 2) + header
    # scanline offset table: one uint64 per line block (1 line for NONE)
    table_start = len(prefix)
    data_start = table_start + 8 * h
    row_bytes = w * 2
    block_bytes = 8 + row_bytes  # y:int32, size:int32, payload
    offsets = [data_start + i * block_bytes for i in range(h)]
    parts = [prefix, struct.pack("<%dQ" % h, *offsets)]
    for y in range(h):
        parts.append(struct.pack("<ii", y, row_bytes))
        parts.append(img[y].tobytes())
    return b"".join(parts)


def _unpredict_deinterleave(raw: bytes) -> bytes:
    """Invert OpenEXR's ZIP pre-compression transform: a byte-delta
    predictor followed by even/odd byte split."""
    d = np.frombuffer(raw, np.uint8).astype(np.int32).copy()
    np.cumsum(d - 128, out=d)
    d = (d + 128).astype(np.uint8)  # modular arithmetic matches uint8 wrap
    n = len(d)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _read_attrs(buf: bytes, pos: int):
    attrs = {}
    while True:
        if buf[pos] == 0:
            return attrs, pos + 1
        e = buf.index(b"\0", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\0", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size


def _parse_chlist(data: bytes):
    channels, pos = [], 0
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        (ptype,) = struct.unpack_from("<i", data, pos)
        pos += 16  # ptype + pLinear/reserved + x/y sampling
        channels.append((name, ptype))
    return channels


def decode_exr(buf: bytes, channel: str = "Z") -> np.ndarray:
    """Decode one channel of a scanline EXR (NONE/ZIPS/ZIP compression)
    to float32 (H, W)."""
    magic, version = struct.unpack_from("<ii", buf, 0)
    assert magic == _MAGIC, "not an EXR file"
    assert not (version & 0x200), "tiled EXR not supported"
    attrs, pos = _read_attrs(buf, 8)

    channels = _parse_chlist(attrs["channels"][1])  # already alphabetical
    comp = attrs["compression"][1][0]
    assert comp in _LINES_PER_BLOCK, f"unsupported EXR compression {comp}"
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (h + lpb - 1) // lpb
    offsets = struct.unpack_from("<%dQ" % n_blocks, buf, pos)

    names = [n for n, _ in channels]
    assert channel in names, f"channel {channel!r} not in {names}"
    itemsize = {0: 4, 1: 2, 2: 4}
    out = np.empty((h, w), np.float32)
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8: off + 8 + size]
        lines = min(lpb, (y1 - y) + 1)
        expect = sum(w * itemsize[p] for _, p in channels) * lines
        # OpenEXR stores the block raw when compression didn't shrink it
        if comp != _C_NONE and size < expect:
            raw = _unpredict_deinterleave(zlib.decompress(raw))
        p = 0
        for ln in range(lines):
            for name, ptype in channels:
                nb = w * itemsize[ptype]
                if name == channel:
                    row = np.frombuffer(raw, _NP_OF_PIXELTYPE[ptype], w, p)
                    out[y - y0 + ln] = row.astype(np.float32)
                p += nb
    return out
