"""Minimal UBJSON codec (Draft-12), compatible with nlohmann::json.

The reference stores corner files as UBJSON (".uson",
reference src/core/board_extractor.cc:475-480 ``to_ubjson`` and
src/io/read_scene.cc:25-41 ``from_ubjson``). This pure-Python codec reads
and writes that wire format (including nlohmann's optimized '$'/'#'
containers) so our pipeline interoperates with artifacts produced by the
reference binaries.
"""

from __future__ import annotations

import struct
from typing import Any

_INT_MARKERS = [
    ("i", "b", -(2 ** 7), 2 ** 7 - 1),
    ("U", "B", 0, 2 ** 8 - 1),
    ("I", ">h", -(2 ** 15), 2 ** 15 - 1),
    ("l", ">i", -(2 ** 31), 2 ** 31 - 1),
    ("L", ">q", -(2 ** 63), 2 ** 63 - 1),
]
_FMT = {"i": "b", "U": "B", "I": ">h", "l": ">i", "L": ">q",
        "d": ">f", "D": ">d", "C": "c"}


def _encode_int(n: int, out: bytearray):
    for marker, fmt, lo, hi in _INT_MARKERS:
        if lo <= n <= hi:
            out += marker.encode()
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _encode_str_payload(s: str, out: bytearray):
    b = s.encode("utf-8")
    _encode_int(len(b), out)
    out += b


def _encode(value: Any, out: bytearray):
    if value is None:
        out += b"Z"
    elif value is True:
        out += b"T"
    elif value is False:
        out += b"F"
    elif isinstance(value, int):
        _encode_int(value, out)
    elif isinstance(value, float):
        out += b"D"
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        out += b"S"
        _encode_str_payload(value, out)
    elif isinstance(value, (list, tuple)):
        out += b"["
        out += b"#"
        _encode_int(len(value), out)
        for v in value:
            _encode(v, out)
        # With '#': no closing marker.
    elif isinstance(value, dict):
        out += b"{"
        out += b"#"
        _encode_int(len(value), out)
        for k, v in value.items():
            _encode_str_payload(str(k), out)
            _encode(v, out)
    else:
        import numpy as np
        if isinstance(value, np.integer):
            _encode_int(int(value), out)
        elif isinstance(value, np.floating):
            out += b"D"
            out += struct.pack(">d", float(value))
        elif isinstance(value, np.ndarray):
            _encode(value.tolist(), out)
        else:
            raise TypeError(f"cannot UBJSON-encode {type(value)}")


def dumps(value: Any) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def marker(self) -> str:
        # Skip no-ops.
        while True:
            m = chr(self.data[self.pos])
            self.pos += 1
            if m != "N":
                return m

    def read_number(self, m: str):
        fmt = _FMT[m]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read_length(self) -> int:
        m = self.marker()
        if m not in ("i", "U", "I", "l", "L"):
            raise ValueError(f"bad length marker {m!r}")
        return int(self.read_number(m))

    def read_str_payload(self) -> str:
        n = self.read_length()
        return self.take(n).decode("utf-8")

    def read_value(self, m: str | None = None):
        m = m or self.marker()
        if m == "Z":
            return None
        if m == "T":
            return True
        if m == "F":
            return False
        if m in ("i", "U", "I", "l", "L"):
            return int(self.read_number(m))
        if m in ("d", "D"):
            return float(self.read_number(m))
        if m == "C":
            return self.take(1).decode()
        if m == "S" or m == "H":
            return self.read_str_payload()
        if m == "[":
            return self.read_array()
        if m == "{":
            return self.read_object()
        raise ValueError(f"unknown marker {m!r} at {self.pos}")

    def _container_header(self):
        type_marker = None
        count = None
        m = self.marker()
        if m == "$":
            type_marker = self.marker()
            m = self.marker()
            if m != "#":
                raise ValueError("'$' without '#'")
            count = self.read_length()
            return type_marker, count, None
        if m == "#":
            count = self.read_length()
            return None, count, None
        return None, None, m

    def read_array(self):
        type_marker, count, first = self._container_header()
        out = []
        if count is not None:
            for _ in range(count):
                out.append(self.read_value(type_marker))
            return out
        m = first
        while m != "]":
            out.append(self.read_value(m))
            m = self.marker()
        return out

    def read_object(self):
        type_marker, count, first = self._container_header()
        out = {}
        if count is not None:
            for _ in range(count):
                k = self.read_str_payload()
                out[k] = self.read_value(type_marker)
            return out
        m = first
        while m != "}":
            # m is the first byte of the key length
            self.pos -= 1
            k = self.read_str_payload()
            out[k] = self.read_value()
            m = self.marker()
        return out


def loads(data: bytes) -> Any:
    return _Reader(data).read_value()
