"""Container formats.

``FLCS`` — the reference-compatible container (reference:
src/compression/format.rs:44-84): 4-byte magic ``FLCS``, 1-byte color type
(0=Gray, 1=Rgb), 1-byte pixel depth (0=8-bit, 1=16-bit), big-endian u32 width,
big-endian u32 height — a 14-byte header — followed by the bit-packed payload.

``FLCT`` — our tiled extension (no reference counterpart): the same
metadata plus a tile grid and a per-tile offset table so tiles decode as
independent bitstreams in parallel across threads and devices. See
``felics_tpu.parallel.tiling`` for the payload layout.

Header-only metadata reads (without touching the payload) are a first-class
capability, matching the reference (src/compression/traits.rs:57-64).
"""

from __future__ import annotations

import enum
import io
import struct
from dataclasses import dataclass
from typing import BinaryIO

from felics_tpu import errors

MAGIC = b"FLCS"
MAGIC_TILED = b"FLCT"

_HEADER_STRUCT = struct.Struct(">4sBBII")
HEADER_SIZE = _HEADER_STRUCT.size  # 14 bytes


class ColorType(enum.IntEnum):
    GRAY = 0
    RGB = 1

    @classmethod
    def from_byte(cls, value: int) -> "ColorType":
        try:
            return cls(value)
        except ValueError:
            raise errors.InvalidColorType(f"invalid color type byte: {value}")


class PixelDepth(enum.IntEnum):
    EIGHT = 0
    SIXTEEN = 1

    @classmethod
    def from_byte(cls, value: int) -> "PixelDepth":
        try:
            return cls(value)
        except ValueError:
            raise errors.InvalidPixelDepth(f"invalid pixel depth byte: {value}")

    @property
    def bits(self) -> int:
        return 8 if self == PixelDepth.EIGHT else 16


@dataclass
class Header:
    color_type: ColorType
    pixel_depth: PixelDepth
    width: int
    height: int

    @property
    def num_channels(self) -> int:
        return 1 if self.color_type == ColorType.GRAY else 3

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def write_header(header: Header, to: BinaryIO, magic: bytes = MAGIC) -> None:
    """Serialize a 14-byte header (reference: src/compression/format.rs:51-61)."""
    to.write(
        _HEADER_STRUCT.pack(
            magic,
            int(header.color_type),
            int(header.pixel_depth),
            header.width,
            header.height,
        )
    )


def header_bytes(header: Header, magic: bytes = MAGIC) -> bytes:
    buf = io.BytesIO()
    write_header(header, buf, magic=magic)
    return buf.getvalue()


def read_header(from_: BinaryIO, magic: bytes = MAGIC) -> Header:
    """Parse and validate a 14-byte header (reference: src/compression/format.rs:63-84).

    Reads exactly ``HEADER_SIZE`` bytes; the payload is untouched, so this
    doubles as the header-only metadata probe.
    """
    raw = from_.read(HEADER_SIZE)
    if len(raw) < HEADER_SIZE:
        raise errors.IoError("unexpected end of stream while reading header")
    got_magic, color_byte, depth_byte, width, height = _HEADER_STRUCT.unpack(raw)
    if got_magic != magic:
        raise errors.InvalidSignature(f"bad magic: {got_magic!r}")
    return Header(
        color_type=ColorType.from_byte(color_byte),
        pixel_depth=PixelDepth.from_byte(depth_byte),
        width=width,
        height=height,
    )


def read_header_bytes(data: bytes, magic: bytes = MAGIC) -> Header:
    return read_header(io.BytesIO(data), magic=magic)
