"""Schema-compiled native Avro decode: Python compiler + ctypes bindings
(port of photon_ml_tpu/data/avro_native.py, with its own copy of the C
decoder at photon_ml_tpu_torch/native/avro_decode.c).

A record schema is compiled once into a flat int32 op program, and the C
interpreter executes it per record over each decompressed container block,
appending leaf values into typed columns: one C loop instead of one Python
decode call per record (the role of the reference's AvroDataReader,
AvroDataReader.scala:53-451).

Columns come back as numpy arrays keyed by field path:
  "label" -> float64 [n];  "uid" -> StrColumn;  "uid#present" -> int64 [n]
  "features#count" -> int64 [n];  "features.name" -> StrColumn (flattened)

The decoder is built with `cc -O3 -shared -fPIC` at first use into
build/photon_ml_tpu_torch/ at the root of the checkout (the library's file
name carries the source's hash, so a changed source is rebuilt); nothing
is built at import time.  Unsupported schema shapes (unions beyond
[null, X], maps with non-string values, fixed) make `compile_schema`
return None and callers read through the pure-Python codec, as do callers
when the build fails (`BUILD_ERROR` then holds the compiler's message).
`ROUTES` counts the files each reader decoded by route ("native" or
"python"), so a caller can require the native route.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.avro_codec import iter_raw_blocks

_SRC = Path(__file__).resolve().parents[1] / "native" / "avro_decode.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "photon_ml_tpu_torch"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

# files decoded per route since the last reset (callers zero the entries)
ROUTES: Dict[str, int] = {"native": 0, "python": 0}
BUILD_ERROR: Optional[str] = None


def note_route(native: bool, files: int = 1) -> None:
    ROUTES["native" if native else "python"] += files


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libavrodec-{digest}.so"


OP_LONG, OP_DOUBLE, OP_FLOAT, OP_BOOL, OP_STRING, OP_ENUM, OP_OPT, \
    OP_ARRAY, OP_MAP_SKIP, OP_MAP = range(10)
KIND_I64, KIND_F64, KIND_STR = range(3)

_PRIMITIVE_OPS = {"long": (OP_LONG, KIND_I64), "int": (OP_LONG, KIND_I64),
                  "double": (OP_DOUBLE, KIND_F64),
                  "float": (OP_FLOAT, KIND_F64),
                  "boolean": (OP_BOOL, KIND_I64),
                  "string": (OP_STRING, KIND_STR),
                  "bytes": (OP_STRING, KIND_STR)}

_lib = None
_lib_failed = False


def _load_lib():
    """Compile (when the hashed library is missing) and load the decoder;
    None when it cannot be built or loaded."""
    global _lib, _lib_failed, BUILD_ERROR
    if _lib is not None or _lib_failed:
        return _lib
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["cc", *CC_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.avrodec_decode_block.restype = ctypes.c_int64
        lib.avrodec_decode_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32]
        lib.avrodec_alloc_cols.restype = ctypes.c_void_p
        lib.avrodec_alloc_cols.argtypes = [ctypes.c_int32,
                                           ctypes.POINTER(ctypes.c_int32)]
        lib.avrodec_free_cols.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        for name, restype in (("avrodec_col_len", ctypes.c_int64),
                              ("avrodec_col_blob_len", ctypes.c_int64),
                              ("avrodec_col_i64", ctypes.POINTER(ctypes.c_int64)),
                              ("avrodec_col_f64", ctypes.POINTER(ctypes.c_double)),
                              ("avrodec_col_blob", ctypes.POINTER(ctypes.c_uint8))):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
    except Exception as e:  # no compiler, a refused source, a bad load
        err = getattr(e, "stderr", None)
        BUILD_ERROR = f"{type(e).__name__}: {e}" + (
            f"\n{err.decode(errors='replace')}" if err else "")
        _lib_failed = True
    return _lib


@dataclasses.dataclass
class StrColumn:
    """Flattened UTF-8 column: `offsets[i]` is the END byte offset of
    element i in `blob` (start = offsets[i-1] or 0)."""

    offsets: np.ndarray  # int64 [n]
    blob: bytes

    def __len__(self) -> int:
        return len(self.offsets)

    def to_list(self) -> List[str]:
        out, start = [], 0
        b = self.blob
        for end in self.offsets.tolist():
            out.append(b[start:end].decode("utf-8"))
            start = end
        return out

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.to_list(), dtype=object)

    def to_bytes_array(self) -> np.ndarray:
        """Fixed-width `S(W)` numpy array, built with a vectorized ragged
        gather — no per-element Python.  This is what lets corpus-scale
        (name, term) -> index mapping run at numpy speed (np.unique /
        searchsorted over the S array) instead of a Python loop per feature
        occurrence."""
        n = len(self.offsets)
        if n == 0:
            return np.zeros(0, dtype="S1")
        offs = self.offsets
        lens = np.diff(offs, prepend=0)
        w = max(int(lens.max()), 1)
        buf = np.zeros((n, w), dtype=np.uint8)
        total = int(offs[-1])
        if total:
            starts = offs - lens
            byte_row = np.repeat(np.arange(n), lens)
            byte_pos = np.arange(total) - np.repeat(starts, lens)
            buf[byte_row, byte_pos] = np.frombuffer(self.blob, np.uint8,
                                                    count=total)
        return buf.view(f"S{w}").ravel()

    def to_str_array(self) -> np.ndarray:
        """Unicode array decoded from the fixed-width bytes (vectorized)."""
        return np.char.decode(self.to_bytes_array(), "utf-8")

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets, prepend=0)

    def take_bytes(self, idx: np.ndarray) -> np.ndarray:
        """Fixed-width `S(W)` array of the SELECTED elements only — the
        padded width is the max over `idx`, not the whole column, so one
        long outlier elsewhere cannot inflate the gather."""
        idx = np.asarray(idx)
        if len(idx) == 0:
            return np.zeros(0, dtype="S1")
        lens_all = self.lengths()
        starts_all = self.offsets - lens_all
        lens = lens_all[idx]
        starts = starts_all[idx]
        w = max(int(lens.max()), 1)
        total = int(lens.sum())
        buf = np.zeros((len(idx), w), dtype=np.uint8)
        if total:
            within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            src = np.repeat(starts, lens) + within
            blob = np.frombuffer(self.blob, np.uint8)
            buf[np.repeat(np.arange(len(idx)), lens), within] = blob[src]
        return buf.view(f"S{w}").ravel()


def resolve_feature_keys(name_cols: List[StrColumn],
                         term_cols: List[StrColumn],
                         index_map=None, delim: bytes = b"\x01"):
    """(name, term) occurrence stream -> (index_map, col_idx [nnz]).

    The one shared implementation of vectorized feature-key resolution
    (used by both the single-bag reader and the merged GAME reader):
    occurrences are bucketed BY TOTAL KEY LENGTH before the fixed-width
    encode, so memory is bounded by the actual key bytes — one long feature
    name cannot inflate the whole stream's padding.  Python only ever
    touches the per-shard VOCABULARY.

    When `index_map` is None a new map is built (sorted keys + intercept,
    IndexMap.from_keys layout); otherwise unseen keys resolve to -1."""
    from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap

    nlens = np.concatenate([c.lengths() for c in name_cols]) \
        if name_cols else np.zeros(0, np.int64)
    tlens = np.concatenate([c.lengths() for c in term_cols]) \
        if term_cols else np.zeros(0, np.int64)
    total = len(nlens)
    if total == 0:
        imap = index_map if index_map is not None else IndexMap.from_keys([])
        return imap, np.zeros(0, np.int64)
    key_lens = nlens + tlens + len(delim)

    # per-length-bucket fixed-width encode + unique
    names_all = concat_str_columns(name_cols)
    terms_all = concat_str_columns(term_cols)
    bucket_vocabs = []
    bucket_codes = np.zeros(total, np.int64)
    bucket_base: List[int] = []
    order_idx = []
    for L in np.unique(key_lens):
        idx = np.flatnonzero(key_lens == L)
        keys_l = np.char.add(np.char.add(names_all.take_bytes(idx), delim),
                             terms_all.take_bytes(idx))
        uniq_l, codes_l = np.unique(keys_l, return_inverse=True)
        bucket_base.append(sum(len(v) for v in bucket_vocabs))
        bucket_vocabs.append(uniq_l)
        bucket_codes[idx] = codes_l + bucket_base[-1]
        order_idx.append(idx)

    # merge bucket vocabularies into one globally sorted vocabulary
    w = max(int(v.dtype.itemsize) for v in bucket_vocabs)
    cat = np.concatenate([v.astype(f"S{w}") for v in bucket_vocabs])
    uniq, inv = np.unique(cat, return_inverse=True)  # inv: bucket slot -> global
    codes = inv[bucket_codes]

    decoded = [k.decode("utf-8") for k in uniq.tolist()]
    if index_map is None:
        index_map = IndexMap.from_keys(decoded, add_intercept=True)
        if INTERCEPT_KEY in decoded:
            # from_keys moves an explicit intercept key to the LAST slot,
            # breaking the sorted-position identity — fall back to lookup
            lut = np.asarray([index_map.key_to_index[k] for k in decoded],
                             dtype=np.int64)
        else:
            # np.unique sorts S-arrays bytewise; UTF-8 byte order ==
            # code-point order, so positions match from_keys' sorted layout
            lut = np.arange(len(uniq), dtype=np.int64)
    else:
        lut = np.asarray([index_map.key_to_index.get(k, -1)
                          for k in decoded], dtype=np.int64)
    return index_map, lut[codes]


def concat_str_columns(cols: List[StrColumn]) -> StrColumn:
    """Concatenate string columns (offsets of later columns are shifted by
    the cumulative blob length)."""
    if len(cols) == 1:
        return cols[0]
    parts, shift = [], 0
    blobs = []
    for c in cols:
        parts.append(c.offsets + shift)
        blobs.append(c.blob)
        shift += len(c.blob)
    return StrColumn(np.concatenate(parts) if parts else
                     np.zeros(0, np.int64), b"".join(blobs))


@dataclasses.dataclass
class DecodePlan:
    program: np.ndarray             # int32 tokens
    columns: List[Tuple[str, int]]  # (path, KIND_*)


def compile_schema(schema_json, decode_maps: bool = False
                   ) -> Optional[DecodePlan]:
    """Record schema -> op program, or None when a shape is unsupported.
    `decode_maps` materializes map<string,string> fields as key/value/count
    columns (GAME id-tag extraction); off by default — skipping is cheaper."""
    tokens: List[int] = []
    columns: List[Tuple[str, int]] = []
    names: Dict[str, dict] = {}
    in_progress: set = set()

    def new_col(path: str, kind: int) -> int:
        columns.append((path, kind))
        return len(columns) - 1

    def emit(node, path: str) -> bool:
        if isinstance(node, str):
            if node in in_progress:
                return False  # self-referential record: no flat program exists
            if node in names:
                return emit(names[node], path)
            if node == "null":
                return True  # nothing to read, nothing to record
            if node not in _PRIMITIVE_OPS:
                return False
            op, kind = _PRIMITIVE_OPS[node]
            tokens.extend([op, new_col(path, kind)])
            return True
        if isinstance(node, list):  # union: only [null, X] / [X, null]
            if len(node) != 2 or "null" not in node:
                return False
            null_idx = node.index("null")
            other = node[1 - null_idx]
            present = new_col(path + "#present", KIND_I64)
            tokens.extend([OP_OPT, null_idx, present])
            fixup = len(tokens)
            tokens.append(-1)  # body length placeholder
            if not emit(other, path):
                return False
            tokens[fixup] = len(tokens) - fixup - 1
            return True
        t = node["type"]
        if t == "record":
            full = node.get("namespace", "") + "." + node["name"] \
                if node.get("namespace") else node["name"]
            names[full] = names[node["name"]] = node
            in_progress.update((full, node["name"]))
            try:
                for f in node["fields"]:
                    fpath = f"{path}.{f['name']}" if path else f["name"]
                    if not emit(f["type"], fpath):
                        return False
            finally:
                in_progress.difference_update((full, node["name"]))
            return True
        if t == "array":
            count = new_col(path + "#count", KIND_I64)
            tokens.extend([OP_ARRAY, count])
            fixup = len(tokens)
            tokens.append(-1)
            if not emit(node["items"], path):
                return False
            tokens[fixup] = len(tokens) - fixup - 1
            return True
        if t == "map":
            values = node["values"]
            if values not in ("string", "bytes"):
                return False
            if not decode_maps:
                tokens.append(OP_MAP_SKIP)
                return True
            # decoded for GAME ingest: id tags may live in metadataMap
            # (reference: GameConverters.getIdTagToValueMapFromRow falls back
            # to the metadata map when no top-level id column exists); other
            # readers skip maps to keep the hot path free of metadata copies
            count = new_col(path + "#count", KIND_I64)
            kcol = new_col(path + ".key", KIND_STR)
            vcol = new_col(path + ".value", KIND_STR)
            tokens.extend([OP_MAP, count, kcol, vcol])
            return True
        if t == "enum":
            tokens.extend([OP_ENUM, new_col(path, KIND_I64)])
            return True
        if isinstance(t, (dict, list)):
            return emit(t, path)  # {"type": {...nested...}}
        return emit(t, path) if t in names or t in _PRIMITIVE_OPS else False

    if not emit(schema_json, ""):
        return None
    return DecodePlan(np.asarray(tokens, dtype=np.int32), columns)


def read_columnar(path: str, decode_maps: bool = False):
    """Decode a container file into columns, or None when the native path
    is unavailable / the schema is unsupported (callers fall back)."""
    lib = _load_lib()
    if lib is None:
        return None
    schema_json, blocks = iter_raw_blocks(path)
    plan = compile_schema(schema_json, decode_maps=decode_maps)
    if plan is None:
        return None

    ncols = len(plan.columns)
    kinds = np.asarray([k for _, k in plan.columns], dtype=np.int32)
    prog = plan.program
    handle = lib.avrodec_alloc_cols(
        ncols, kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if not handle:
        return None
    try:
        for count, data in blocks:
            consumed = lib.avrodec_decode_block(
                data, len(data), count,
                prog.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(prog), handle, ncols)
            if consumed != len(data):
                raise ValueError(
                    f"{path}: native Avro decode failed (consumed {consumed} "
                    f"of {len(data)} block bytes)")
        def as_np(ptr, n, dtype):
            # string_at does one bulk memcpy; frombuffer views it (the
            # ctypeslib.as_array route converts elementwise — far too slow)
            if not n:
                return np.zeros(0, dtype)
            raw = ctypes.string_at(ptr, n * np.dtype(dtype).itemsize)
            return np.frombuffer(raw, dtype=dtype)

        out = {}
        for i, (name, kind) in enumerate(plan.columns):
            n = lib.avrodec_col_len(handle, i)
            if kind == KIND_F64:
                out[name] = as_np(lib.avrodec_col_f64(handle, i), n,
                                  np.float64)
            elif kind == KIND_I64:
                out[name] = as_np(lib.avrodec_col_i64(handle, i), n,
                                  np.int64)
            else:
                bn = lib.avrodec_col_blob_len(handle, i)
                blob = lib.avrodec_col_blob(handle, i)
                out[name] = StrColumn(
                    as_np(lib.avrodec_col_i64(handle, i), n, np.int64),
                    ctypes.string_at(blob, bn) if bn else b"")
        return out
    finally:
        lib.avrodec_free_cols(handle, ncols)
