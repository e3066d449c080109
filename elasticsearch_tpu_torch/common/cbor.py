"""CBOR (RFC 7049) codec — the binary XContent type.

The reference's JDBC/ODBC clients negotiate binary communication with
the SQL endpoints by sending and accepting ``application/cbor`` bodies
(ref: x-pack/plugin/sql/sql-proto — SqlQueryRequest ``binary_format``,
and libs/x-content's CborXContent which backs every REST endpoint's
content-type negotiation). This is a stdlib-only implementation of the
subset XContent emits: unsigned/negative integers, IEEE-754 doubles,
UTF-8 text strings, byte strings, arrays, maps, booleans and null —
plus decode support for half/single floats and indefinite-length
containers so foreign encoders interoperate.
"""

from __future__ import annotations

import struct
from typing import Any

_BREAK = object()


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 0x100:
        return bytes([(major << 5) | 24, arg])
    if arg < 0x10000:
        return bytes([(major << 5) | 25]) + struct.pack(">H", arg)
    if arg < 0x100000000:
        return bytes([(major << 5) | 26]) + struct.pack(">I", arg)
    return bytes([(major << 5) | 27]) + struct.pack(">Q", arg)


def _encode(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xf6")
    elif obj is True:
        out.append(b"\xf5")
    elif obj is False:
        out.append(b"\xf4")
    elif isinstance(obj, int):
        if 0 <= obj < 2**64:
            out.append(_head(0, obj))
        elif -2**64 <= obj < 0:
            out.append(_head(1, -1 - obj))
        else:
            # out of 64-bit head range: bignum territory — emit the
            # decimal string, like the json path's default=str fallback
            _encode(str(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xfb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(3, len(b)))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_head(2, len(b)))
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(4, len(obj)))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        out.append(_head(5, len(obj)))
        for k, v in obj.items():
            _encode(k if isinstance(k, (str, bytes, int)) else str(k), out)
            _encode(v, out)
    else:
        # same fallback json.dumps(default=str) uses elsewhere in the repo
        _encode(str(obj), out)


def dumps(obj: Any) -> bytes:
    out: list = []
    _encode(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class CborDecodeError(ValueError):
    pass


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise CborDecodeError("truncated CBOR input")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        return self.take(1)[0]


def _half_to_float(h: int) -> float:
    # IEEE 754 binary16 → float (RFC 7049 appendix D)
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF
    if exp == 0:
        val = mant * 2.0 ** -24
    elif exp != 31:
        val = (mant + 1024) * 2.0 ** (exp - 25)
    else:
        val = float("inf") if mant == 0 else float("nan")
    return -val if h & 0x8000 else val


def _arg(r: _Reader, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return r.byte()
    if info == 25:
        return struct.unpack(">H", r.take(2))[0]
    if info == 26:
        return struct.unpack(">I", r.take(4))[0]
    if info == 27:
        return struct.unpack(">Q", r.take(8))[0]
    raise CborDecodeError(f"reserved additional info {info}")


_MAX_DEPTH = 256


def _decode(r: _Reader, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise CborDecodeError("nesting depth exceeds limit")
    ib = r.byte()
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _arg(r, info)
    if major == 1:
        return -1 - _arg(r, info)
    if major == 2 or major == 3:
        if info == 31:  # indefinite-length string: concat definite chunks
            parts = []
            while True:
                nb = r.byte()
                if nb == 0xFF:
                    break
                if nb >> 5 != major:
                    raise CborDecodeError("mixed chunk types")
                parts.append(r.take(_arg(r, nb & 0x1F)))
            b = b"".join(parts)
        else:
            b = r.take(_arg(r, info))
        return b.decode("utf-8") if major == 3 else b
    if major == 4:
        if info == 31:
            arr = []
            while True:
                v = _decode(r, depth + 1)
                if v is _BREAK:
                    return arr
                arr.append(v)
        return [_decode(r, depth + 1) for _ in range(_arg(r, info))]
    if major == 5:
        d = {}
        if info == 31:
            while True:
                k = _decode(r, depth + 1)
                if k is _BREAK:
                    return d
                d[_map_key(k)] = _decode(r, depth + 1)
        for _ in range(_arg(r, info)):
            k = _decode(r, depth + 1)
            d[_map_key(k)] = _decode(r, depth + 1)
        return d
    if major == 6:  # tag — decode and surface the payload (tags 0/1 are
        _arg(r, info)  # datetime hints; the payload already carries the value)
        return _decode(r, depth + 1)
    # major 7: simple values + floats
    if info == 20:
        return False
    if info == 21:
        return True
    if info == 22 or info == 23:
        return None
    if info == 25:
        return _half_to_float(struct.unpack(">H", r.take(2))[0])
    if info == 26:
        return struct.unpack(">f", r.take(4))[0]
    if info == 27:
        return struct.unpack(">d", r.take(8))[0]
    if info == 31:
        return _BREAK
    if info < 24 or info == 24:
        return _arg(r, info)  # unassigned simple value — surface the number
    raise CborDecodeError(f"unsupported major-7 info {info}")


def _map_key(k: Any) -> Any:
    if isinstance(k, (str, bytes, int, float, bool)) or k is None:
        return k
    raise CborDecodeError(f"unhashable map key type {type(k).__name__}")


def loads(data: bytes) -> Any:
    r = _Reader(bytes(data))
    v = _decode(r)
    if v is _BREAK:
        raise CborDecodeError("unexpected break code")
    if r.pos != len(r.buf):
        raise CborDecodeError(
            f"{len(r.buf) - r.pos} trailing bytes after CBOR value")
    return v
