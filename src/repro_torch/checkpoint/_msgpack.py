"""The part of MessagePack that checkpoint manifests use: nil, booleans,
integers, f64 floats, strings, arrays and maps.

``packb`` writes what ``msgpack.packb`` writes with its defaults (the
smallest integer form, f64 floats), so a manifest reads alike with this
module or the ``msgpack`` package, which the port does not depend on.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8 / 16 /
    32-bit (``codes``: one per width, the 8-bit one only for strings)."""
    if n < fix_max:
        out.append(fix | n)
        return
    sizes = (("B", 0xff), ("H", 0xffff), ("I", 0xffffffff))[-len(codes):]
    for code, (fmt, top) in zip(codes, sizes):
        if n <= top:
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError("object too large for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xff)
    elif n > 0:
        for code, fmt, top in ((0xcc, "B", 0xff), (0xcd, "H", 0xffff),
                               (0xce, "I", 0xffffffff),
                               (0xcf, "Q", 0xffffffffffffffff)):
            if n <= top:
                out.append(code)
                out += struct.pack(">" + fmt, n)
                return
        raise OverflowError("integer too large for msgpack")
    else:
        for code, fmt, low in ((0xd0, "b", -0x80), (0xd1, "h", -0x8000),
                               (0xd2, "i", -0x80000000),
                               (0xd3, "q", -0x8000000000000000)):
            if n >= low:
                out.append(code)
                out += struct.pack(">" + fmt, n)
                return
        raise OverflowError("integer too small for msgpack")


# fixed-size values by their code: (struct format, byte count)
_FIXED = {0xcb: (">d", 8), 0xcc: (">B", 1),
          0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
          0xd3: (">q", 8)}
# lengths of str / array / map by their code: (kind, length format)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xe0:
        return code - 0x100, i
    if code == 0xc0:
        return None, i
    if code in (0xc2, 0xc3):
        return code == 0xc3, i
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0xa0 <= code < 0xc0:
        kind, n = "str", code & 0x1f
    elif 0x90 <= code < 0xa0:
        kind, n = "array", code & 0x0f
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0f
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"unsupported msgpack code 0x{code:02x}")
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
