"""Shared binary-format constants and helpers for ``.matok``/``.datok``.

Serialization is little-endian, gzipped, with a 5-byte magic
(reference datok.go:39-49, matrix.go:11-14).
"""

from __future__ import annotations

import gzip
import struct

MAMAGIC = b"MATOK"
DAMAGIC = b"DATOK"
VERSION = 1
EOT = 4

FIRSTBIT = 1 << 31
SECONDBIT = 1 << 30
RESTBIT = (1 << 32) - 1 - FIRSTBIT - SECONDBIT


def put_u16(buf: bytearray, v: int) -> None:
    buf += struct.pack("<H", v & 0xFFFF)


def put_u32(buf: bytearray, v: int) -> None:
    buf += struct.pack("<I", v & 0xFFFFFFFF)


def encode_rune(cp: int) -> bytes:
    """UTF-8 encode a codepoint; NUL encodes as a single 0x00 byte.

    Matches Go's ``WriteRune`` behaviour for the zero placeholders left
    in the sigma list for special symbols (matrix.go:172-180).
    """
    return chr(cp).encode("utf-8")


def read_rune(data: bytes, off: int):
    """Decode one UTF-8 rune at ``off``; returns (codepoint, next_off).

    Mirrors Go ``ReadRune``: invalid bytes decode as U+FFFD advancing 1.
    """
    b0 = data[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return 0xFFFD, off + 1
    if b0 < 0xE0:
        n = 2
    elif b0 < 0xF0:
        n = 3
    else:
        n = 4
    chunk = data[off : off + n]
    try:
        cp = ord(chunk.decode("utf-8"))
    except (UnicodeDecodeError, TypeError):
        return 0xFFFD, off + 1
    return cp, off + n


def gz_read(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def gz_write(path: str, payload: bytes) -> None:
    # no file name and a zero mtime in the gzip header, like Go's
    # gzip.Writer: equal models give byte-identical files
    with open(path, "wb") as f:
        with gzip.GzipFile(filename="", fileobj=f, mode="wb", mtime=0,
                           compresslevel=6) as gz:
            gz.write(payload)


def load_tokenizer_file(path: str):
    """Magic-dispatch loader (fomafile.go:452-484)."""
    data = gz_read(path)
    if data[:5] == MAMAGIC:
        from .matrix import parse_matrix

        return parse_matrix(data)
    if data[:5] == DAMAGIC:
        from .double_array import parse_datok

        return parse_datok(data)
    raise ValueError("Neither a matrix nor a datok file")
