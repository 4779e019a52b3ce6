"""Minimal pure-Python Avro Object Container File codec
(a copy of photon_ml_tpu/data/avro_codec.py; host code).

The environment has no avro/fastavro package, and the reference's entire I/O
surface is Avro (photon-avro-schemas/src/main/avro/*.avsc; readers/writers in
photon-client/.../data/avro/AvroUtils.scala).  This module implements the
published Avro 1.x specification subset those schemas need:

  types:  null, boolean, int, long, float, double, bytes, string,
          record, enum, array, map, union, fixed
  files:  Object Container Format (magic Obj\\x01, metadata map with
          avro.schema/avro.codec, 16-byte sync marker, data blocks)
  codecs: null, deflate (raw zlib)

Generic data model: records are dicts, arrays are lists, unions pick the
first matching branch.  This is an independent implementation from the Avro
spec, not a port of any Avro library.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator, List

MAGIC = b"Obj\x01"
DEFAULT_SYNC = b"\x50\x48\x4f\x54\x4f\x4e\x2d\x54\x50\x55\x2d\x53\x59\x4e\x43\x21"  # 16B

# ---------------------------------------------------------------------------
# primitive binary encoding
# ---------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else (((-n) << 1) - 1)


def write_long(buf: io.BytesIO, n: int) -> None:
    z = (n << 1) ^ (n >> 63)  # arithmetic shift handles negatives
    z &= (1 << 64) - 1
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            break


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("unexpected end of Avro data")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag decode


def write_bytes(buf: io.BytesIO, b: bytes) -> None:
    write_long(buf, len(b))
    buf.write(b)


def read_bytes(buf: BinaryIO) -> bytes:
    n = read_long(buf)
    return buf.read(n)


# ---------------------------------------------------------------------------
# schema-driven encode/decode
# ---------------------------------------------------------------------------


class Schema:
    """Parsed schema with named-type registry (records referenced by name)."""

    def __init__(self, schema_json: Any):
        self.names: dict[str, Any] = {}
        self.root = self._resolve(schema_json)

    def _resolve(self, s: Any) -> Any:
        if isinstance(s, str):
            if s in ("null", "boolean", "int", "long", "float", "double",
                     "bytes", "string"):
                return s
            if s in self.names:
                return self.names[s]
            raise ValueError(f"unknown type name {s!r}")
        if isinstance(s, list):
            return ["union", [self._resolve(b) for b in s]]
        t = s["type"]
        if t in ("record", "error"):
            rec = {"type": "record", "name": s["name"], "fields": []}
            self.names[s["name"]] = rec
            full = s.get("namespace", "") + "." + s["name"] if s.get("namespace") else s["name"]
            self.names[full] = rec
            rec["fields"] = [{"name": f["name"],
                              "type": self._resolve(f["type"]),
                              "default": f.get("default")}
                             for f in s["fields"]]
            return rec
        if t == "enum":
            e = {"type": "enum", "name": s["name"], "symbols": s["symbols"]}
            self.names[s["name"]] = e
            return e
        if t == "fixed":
            fx = {"type": "fixed", "name": s["name"], "size": s["size"]}
            self.names[s["name"]] = fx
            return fx
        if t == "array":
            return {"type": "array", "items": self._resolve(s["items"])}
        if t == "map":
            return {"type": "map", "values": self._resolve(s["values"])}
        return self._resolve(t)  # {"type": "string"} style


def _branch_matches(branch: Any, value: Any) -> bool:
    kind = branch if isinstance(branch, str) else branch.get("type", "union")
    if kind == "null":
        return value is None
    if value is None:
        return False
    if kind == "boolean":
        return isinstance(value, bool)
    if kind in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if kind in ("float", "double"):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if kind == "string":
        return isinstance(value, str)
    if kind in ("bytes", "fixed"):
        return isinstance(value, bytes)
    if kind == "record":
        return isinstance(value, dict)
    if kind == "map":
        return isinstance(value, dict)
    if kind == "array":
        return isinstance(value, (list, tuple))
    if kind == "enum":
        return isinstance(value, str)
    return False


def encode(buf: io.BytesIO, schema: Any, value: Any) -> None:
    kind = schema if isinstance(schema, str) else (
        "union" if isinstance(schema, list) and schema[0] == "union" else schema["type"])
    if kind == "null":
        return
    if kind == "boolean":
        buf.write(b"\x01" if value else b"\x00")
    elif kind in ("int", "long"):
        write_long(buf, int(value))
    elif kind == "float":
        buf.write(struct.pack("<f", float(value)))
    elif kind == "double":
        buf.write(struct.pack("<d", float(value)))
    elif kind == "bytes":
        write_bytes(buf, value)
    elif kind == "string":
        write_bytes(buf, value.encode("utf-8"))
    elif kind == "fixed":
        assert len(value) == schema["size"]
        buf.write(value)
    elif kind == "enum":
        write_long(buf, schema["symbols"].index(value))
    elif kind == "union":
        branches = schema[1]
        for i, branch in enumerate(branches):
            if _branch_matches(branch, value):
                write_long(buf, i)
                encode(buf, branch, value)
                return
        raise TypeError(f"value {value!r} matches no union branch")
    elif kind == "array":
        if value:
            write_long(buf, len(value))
            for item in value:
                encode(buf, schema["items"], item)
        write_long(buf, 0)
    elif kind == "map":
        if value:
            write_long(buf, len(value))
            for k, v in value.items():
                write_bytes(buf, k.encode("utf-8"))
                encode(buf, schema["values"], v)
        write_long(buf, 0)
    elif kind == "record":
        for f in schema["fields"]:
            fv = value.get(f["name"], f.get("default"))
            encode(buf, f["type"], fv)
    else:
        raise ValueError(f"unsupported schema kind {kind!r}")


def decode(buf: BinaryIO, schema: Any) -> Any:
    kind = schema if isinstance(schema, str) else (
        "union" if isinstance(schema, list) and schema[0] == "union" else schema["type"])
    if kind == "null":
        return None
    if kind == "boolean":
        return buf.read(1) == b"\x01"
    if kind in ("int", "long"):
        return read_long(buf)
    if kind == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if kind == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if kind == "bytes":
        return read_bytes(buf)
    if kind == "string":
        return read_bytes(buf).decode("utf-8")
    if kind == "fixed":
        return buf.read(schema["size"])
    if kind == "enum":
        return schema["symbols"][read_long(buf)]
    if kind == "union":
        return decode(buf, schema[1][read_long(buf)])
    if kind == "array":
        out: List[Any] = []
        while True:
            n = read_long(buf)
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                read_long(buf)
                n = -n
            for _ in range(n):
                out.append(decode(buf, schema["items"]))
        return out
    if kind == "map":
        res = {}
        while True:
            n = read_long(buf)
            if n == 0:
                break
            if n < 0:
                read_long(buf)
                n = -n
            for _ in range(n):
                k = read_bytes(buf).decode("utf-8")
                res[k] = decode(buf, schema["values"])
        return res
    if kind == "record":
        return {f["name"]: decode(buf, f["type"]) for f in schema["fields"]}
    raise ValueError(f"unsupported schema kind {kind!r}")


# ---------------------------------------------------------------------------
# Object Container Files
# ---------------------------------------------------------------------------


def write_container(path: str, schema_json: Any, records: Iterable[dict],
                    codec: str = "deflate", block_records: int = 4096) -> None:
    schema = Schema(schema_json)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = io.BytesIO()
        header = {"avro.schema": json.dumps(schema_json).encode(),
                  "avro.codec": codec.encode()}
        write_long(meta, len(header))
        for k, v in header.items():
            write_bytes(meta, k.encode())
            write_bytes(meta, v)
        write_long(meta, 0)
        f.write(meta.getvalue())
        f.write(DEFAULT_SYNC)

        batch: List[dict] = []

        def flush():
            if not batch:
                return
            body = io.BytesIO()
            for r in batch:
                encode(body, schema.root, r)
            data = body.getvalue()
            if codec == "deflate":
                # raw deflate (no zlib header/checksum), per the Avro spec
                co = zlib.compressobj(9, zlib.DEFLATED, -15)
                data = co.compress(data) + co.flush()
            elif codec != "null":
                raise ValueError(f"unsupported codec {codec}")
            blk = io.BytesIO()
            write_long(blk, len(batch))
            write_long(blk, len(data))
            f.write(blk.getvalue())
            f.write(data)
            f.write(DEFAULT_SYNC)
            batch.clear()

        for rec in records:
            batch.append(rec)
            if len(batch) >= block_records:
                flush()
        flush()


def _read_header(f: BinaryIO, path: str):
    """-> (schema_json, codec, sync marker); leaves f at the first block."""
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    header = {}
    while True:
        n = read_long(f)
        if n == 0:
            break
        if n < 0:
            read_long(f)
            n = -n
        for _ in range(n):
            k = read_bytes(f).decode()
            header[k] = read_bytes(f)
    schema_json = json.loads(header["avro.schema"])
    codec = header.get("avro.codec", b"null").decode()
    return schema_json, codec, f.read(16)


def iter_raw_blocks(path: str):
    """-> (schema_json, iterator of (record_count, decompressed bytes)).

    The block-granular read path for vectorized/native decoders.  The header
    is read eagerly and the file closed; the generator reopens it, so an
    abandoned iterator never holds an fd."""
    with open(path, "rb") as f:
        schema_json, codec, _sync = _read_header(f, path)
        data_start = f.tell()

    def blocks():
        with open(path, "rb") as f:
            f.seek(data_start)
            while True:
                try:
                    count = read_long(f)
                except EOFError:
                    return
                size = read_long(f)
                data = f.read(size)
                if codec == "deflate":
                    data = zlib.decompress(data, -15)
                elif codec != "null":
                    raise ValueError(f"unsupported codec {codec}")
                f.read(16)  # sync marker
                yield count, data

    return schema_json, blocks()


def read_container(path: str) -> Iterator[dict]:
    with open(path, "rb") as f:
        schema_json, codec, sync = _read_header(f, path)
        schema = Schema(schema_json)
        while True:
            try:
                count = read_long(f)
            except EOFError:
                return
            size = read_long(f)
            data = f.read(size)
            if codec == "deflate":
                data = zlib.decompress(data, -15)
            elif codec != "null":
                raise ValueError(f"unsupported codec {codec}")
            body = io.BytesIO(data)
            for _ in range(count):
                yield decode(body, schema.root)
            if f.read(16) != sync:
                raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
