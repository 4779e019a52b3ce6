"""Log-to-dataset compactor: the durable feedback lane -> sealed,
sha256'd training chunk files the streaming tier can consume directly (a
copy of photon_ml_tpu/refit/compactor.py: host numpy, and byte-compatible,
so a chunk store either package writes resumes in the other).

The compactor replays `fleet.FeedbackLog` batches (labeled Observations
with their trace-stamped intake wall times) into fixed-size chunk files
in a stable global row order — (log seq, intra-batch index) — so the
output is a pure function of the log contents:

  * DETERMINISTIC: the same log always compacts to bit-identical chunk
    files, regardless of how many runs, restarts, or SIGKILLs it took to
    get there.  A chunk is sealed only when FULL (`chunk_rows` rows), so
    batch arrival patterns cannot shift chunk boundaries; the unsealed
    tail is re-read from the log on every run (`tail_rows()`).
  * INCREMENTAL: `manifest.json` records the resume position (next log
    seq + row offset within it); a restarted compactor re-reads only the
    unconsumed suffix.  Records the compactor has sealed are safe for
    the lane to prune — `checkpoint_seq()` is the retention hook the
    FeedbackLog's `register_consumer` bounds compaction with.
  * DURABLE: chunk files and the manifest go through
    utils.durable atomic replace + fsync; every chunk carries a sha256
    over its canonical encoding and the manifest lists it, so a torn or
    bit-rotted chunk is detected at read time, not at fit time.

Chunk geometry matches the streaming tier: `chunk_rows` is a power of
two, so `ChunkPlan.build(sealed_rows, chunk_rows=...)` yields specs whose
[start, stop) ranges align 1:1 with chunk files and `fetch()` feeds a
`Prefetcher` without re-slicing.

Fault site `refit.compact` fires before each chunk seal: transient
faults retry with the staging backoff discipline, a "kill" is the
canonical mid-compaction crash (the resume test restarts and converges
bit-identically), fatal ones raise CompactionError.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.fleet.replog import (decode_array, encode_array,
                                        feedback_from_record)
from photon_ml_tpu_torch.utils import durable, faults

CHUNK_PREFIX = "chunk-"
CHUNK_SUFFIX = ".json"
MANIFEST_NAME = "manifest.json"


class CompactionError(RuntimeError):
    """Structural compaction failure: schema drift across batches, a
    manifest/chunk hash mismatch, or a fatal injected fault."""


@dataclasses.dataclass(frozen=True)
class CompactorConfig:
    #: rows per sealed chunk (power of two — ChunkPlan geometry)
    chunk_rows: int = 1024
    #: transient-fault retry budget per chunk seal (staging parity)
    max_attempts: int = 4
    backoff_s: float = 0.05

    def __post_init__(self):
        r = int(self.chunk_rows)
        if r < 1 or (r & (r - 1)) != 0:
            raise ValueError(f"chunk_rows must be a power of two, got {r}")


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _chunk_sha(body: dict) -> str:
    return hashlib.sha256(_canonical(body).encode()).hexdigest()


def _chunk_name(index: int) -> str:
    return f"{CHUNK_PREFIX}{index:06d}{CHUNK_SUFFIX}"


class _RowBuffer:
    """Accumulates log rows in global order; tracks per-row provenance
    (log seq) so sealed chunks record their seq/wall ranges and the
    resume position lands exactly after the last sealed row."""

    def __init__(self, schema: Optional[dict] = None):
        self.schema = schema  # {"features": {shard: dim}, "ids": [types]}
        self.features: Dict[str, List[np.ndarray]] = {}
        self.ids: Dict[str, List[str]] = {}
        self.labels: List[float] = []
        self.weights: List[float] = []
        self.offsets: List[float] = []
        self.wall: List[float] = []
        self.seqs: List[int] = []
        self.offs: List[int] = []  # intra-batch row offset per row

    def __len__(self) -> int:
        return len(self.labels)

    def extend(self, seq: int, batch: dict, start_offset: int = 0) -> None:
        feats = batch["features"]
        schema = {"features": {s: int(np.asarray(a).shape[1])
                               for s, a in sorted(feats.items())},
                  "ids": sorted(batch["ids"])}
        if self.schema is None:
            self.schema = schema
        elif schema != self.schema:
            raise CompactionError(
                f"feedback schema drift at log seq {seq}: expected "
                f"{self.schema}, got {schema} — the compactor's chunks "
                "share one row layout")
        n = int(batch["labels"].shape[0])
        for i in range(start_offset, n):
            for s in feats:
                self.features.setdefault(s, []).append(
                    np.asarray(feats[s][i], np.float64))
            for t in batch["ids"]:
                self.ids.setdefault(t, []).append(
                    str(np.asarray(batch["ids"][t])[i]))
            self.labels.append(float(batch["labels"][i]))
            self.weights.append(float(batch["weights"][i]))
            self.offsets.append(float(batch["offsets"][i]))
            self.wall.append(float(batch["wall_s"]))
            self.seqs.append(int(seq))
            self.offs.append(int(i))

    def take(self, rows: int) -> dict:
        """Pop the first `rows` rows as host arrays + provenance."""
        out = {
            "features": {s: np.stack(v[:rows])
                         for s, v in self.features.items()},
            "ids": {t: list(v[:rows]) for t, v in self.ids.items()},
            "labels": np.asarray(self.labels[:rows], np.float64),
            "weights": np.asarray(self.weights[:rows], np.float64),
            "offsets": np.asarray(self.offsets[:rows], np.float64),
            "wall": np.asarray(self.wall[:rows], np.float64),
            "seq_range": [int(self.seqs[0]), int(self.seqs[rows - 1])],
            "last_seq": int(self.seqs[rows - 1]),
            "last_off": int(self.offs[rows - 1]),
        }
        for s in list(self.features):
            del self.features[s][:rows]
        for t in list(self.ids):
            del self.ids[t][:rows]
        del self.labels[:rows]
        del self.weights[:rows]
        del self.offsets[:rows]
        del self.wall[:rows]
        del self.seqs[:rows]
        del self.offs[:rows]
        return out


class LogCompactor:
    """Replay the feedback lane into sealed chunk files + manifest.

    One compactor per output directory (the manifest is its durable
    state).  Register it on the lane for bounded retention:

        log.register_consumer("refit-compactor", compactor.checkpoint_seq)
    """

    def __init__(self, log, out_dir: str,
                 config: CompactorConfig = CompactorConfig()):
        self.log = log
        self.out_dir = str(out_dir)
        self.config = config
        os.makedirs(self.out_dir, exist_ok=True)
        self._jitter = random.Random(0x5EED)
        self._batch_sizes: Dict[int, int] = {}
        self._seen: Optional[Dict[str, set]] = None

    # -- manifest ------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.out_dir, MANIFEST_NAME)

    def manifest(self) -> dict:
        path = self._manifest_path()
        if not os.path.exists(path):
            return {"format_version": 1,
                    "chunk_rows": int(self.config.chunk_rows),
                    "schema": None, "chunks": [], "sealed_rows": 0,
                    "resume": {"next_seq": 1, "offset": 0},
                    "covered_seqs": [1, 0], "time_range": None,
                    "coverage": {}}
        with open(path) as f:
            m = json.load(f)
        if int(m["chunk_rows"]) != int(self.config.chunk_rows):
            raise CompactionError(
                f"manifest chunk_rows {m['chunk_rows']} != configured "
                f"{self.config.chunk_rows} — chunk geometry is part of "
                "the output's identity; use a fresh out_dir to change it")
        return m

    def checkpoint_seq(self) -> int:
        """Newest log seq whose every row is sealed in durable chunks —
        the lane may prune up to here (the retention hook)."""
        return int(self.manifest()["resume"]["next_seq"]) - 1

    # -- compaction ----------------------------------------------------------

    def compact(self) -> dict:
        """One incremental pass: consume the lane's unconsumed suffix,
        seal every full chunk, update the manifest.  Returns the updated
        manifest.  Idempotent and crash-safe: re-running after any
        interruption converges to the same bit-identical chunk files."""
        m = self.manifest()
        resume = m["resume"]
        next_seq, offset = int(resume["next_seq"]), int(resume["offset"])
        buf = _RowBuffer(m["schema"])
        chunk_rows = int(self.config.chunk_rows)
        sealed = 0
        # what the pass has read: each batch's row count and the entity ids
        # of the sealed chunks (the JAX package re-reads the log and every
        # chunk file per seal for these; the manifest bytes are the same)
        self._batch_sizes = {}
        self._seen = None
        for env in self.log.read(next_seq - 1):
            seq = int(env["log_seq"])
            rec = env["record"]
            if rec.get("kind") != "feedback":
                continue  # a mixed lane: non-feedback records are not rows
            self._batch_sizes[seq] = int(rec.get("rows", 0))
            batch = feedback_from_record(rec)
            buf.extend(seq, batch, offset if seq == next_seq else 0)
            while len(buf) >= chunk_rows:
                self._seal_chunk(m, buf.take(chunk_rows))
                sealed += 1
        if sealed:
            telemetry.event("refit_compacted", chunks=sealed,
                            sealed_rows=int(m["sealed_rows"]),
                            checkpoint_seq=int(m["resume"]["next_seq"]) - 1)
        return m

    def _seal_chunk(self, m: dict, rows: dict) -> None:
        index = len(m["chunks"])
        start_row = int(m["sealed_rows"])
        body = {
            "format_version": 1, "index": index, "start_row": start_row,
            "rows": int(rows["labels"].shape[0]),
            "features": {s: encode_array(a)
                         for s, a in rows["features"].items()},
            "ids": rows["ids"],
            "labels": encode_array(rows["labels"]),
            "weights": encode_array(rows["weights"]),
            "offsets": encode_array(rows["offsets"]),
            "wall": encode_array(rows["wall"]),
            "seq_range": rows["seq_range"],
            "wall_range": [float(rows["wall"].min()),
                           float(rows["wall"].max())],
        }
        sha = _chunk_sha(body)
        name = _chunk_name(index)
        path = os.path.join(self.out_dir, name)
        cfg = self.config
        attempt = 0
        while True:
            attempt += 1
            try:
                faults.fire("refit.compact", chunk=str(index))
                if os.path.exists(path):
                    # resume over a chunk a previous run already sealed:
                    # it must be OUR chunk, bit for bit
                    existing = _read_chunk(path)
                    if existing["sha"] != sha:
                        raise CompactionError(
                            f"existing {name} hashes {existing['sha'][:12]} "
                            f"but this log replay produced {sha[:12]} — "
                            "the chunk store and the log disagree")
                else:
                    durable.atomic_write_text(
                        path, _canonical({**body, "sha": sha}) + "\n")
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except CompactionError:
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise CompactionError(
                        f"sealing {name} failed: "
                        f"{type(e).__name__}: {e}") from e
                telemetry.event("refit_compact_retry", chunk=index,
                                attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))
        # manifest update AFTER the chunk is durable: a crash between the
        # two re-seals the same chunk next run (idempotent by hash check)
        m["schema"] = m["schema"] or {
            "features": {s: int(a.shape[1])
                         for s, a in sorted(rows["features"].items())},
            "ids": sorted(rows["ids"])}
        m["chunks"].append({
            "name": name, "rows": body["rows"], "sha256": sha,
            "start_row": start_row, "seq_range": body["seq_range"],
            "wall_range": body["wall_range"]})
        m["sealed_rows"] = start_row + body["rows"]
        # resume position: the row right after the last sealed one
        last_seq, last_off = rows["last_seq"], rows["last_off"]
        if last_off + 1 >= self._batch_sizes[last_seq]:
            m["resume"] = {"next_seq": last_seq + 1, "offset": 0}
        else:
            m["resume"] = {"next_seq": last_seq, "offset": last_off + 1}
        m["covered_seqs"] = [1, int(m["resume"]["next_seq"]) - 1]
        lo, hi = body["wall_range"]
        tr = m.get("time_range")
        m["time_range"] = ([lo, hi] if tr is None
                           else [min(tr[0], lo), max(tr[1], hi)])
        m["coverage"] = self._coverage(m, rows["ids"])
        durable.atomic_write_json(self._manifest_path(), m)

    def _coverage(self, m: dict, new_ids: Dict[str, list]) -> Dict[str, int]:
        """Distinct entity ids per type across sealed chunks (read from the
        chunk files at a pass's first seal, then kept up to date with each
        new chunk's ids — the manifest stays small)."""
        if self._seen is None:
            self._seen = {}
            for entry in m["chunks"]:
                chunk = _read_chunk(os.path.join(self.out_dir, entry["name"]))
                for t, vals in chunk["ids"].items():
                    self._seen.setdefault(t, set()).update(vals)
        else:
            for t, vals in new_ids.items():
                self._seen.setdefault(t, set()).update(vals)
        return {t: len(v) for t, v in sorted(self._seen.items())}

    # -- unsealed tail -------------------------------------------------------

    def tail_rows(self) -> Optional[dict]:
        """The unsealed suffix of the log as host arrays (rows past the
        last sealed chunk) — the freshest feedback a refit trains on
        before it is chunk-durable.  None when the tail is empty."""
        m = self.manifest()
        resume = m["resume"]
        next_seq, offset = int(resume["next_seq"]), int(resume["offset"])
        buf = _RowBuffer(m["schema"])
        for env in self.log.read(next_seq - 1):
            seq = int(env["log_seq"])
            rec = env["record"]
            if rec.get("kind") != "feedback":
                continue
            buf.extend(seq, feedback_from_record(rec),
                       offset if seq == next_seq else 0)
        if not len(buf):
            return None
        return buf.take(len(buf))


# -- reading ------------------------------------------------------------------

def _read_chunk(path: str) -> dict:
    with open(path) as f:
        body = json.loads(f.read())
    sha = body.pop("sha", None)
    if sha != _chunk_sha(body):
        raise CompactionError(
            f"chunk {os.path.basename(path)} failed its sha256 check — "
            "torn write or bit rot; recompact from the log")
    body["sha"] = sha
    return body


class CompactedDataset:
    """Read side of a compactor output directory: manifest-verified chunk
    access shaped for both consumers — `fetch()` feeds the streaming
    tier's Prefetcher per ChunkSpec, `to_game_dataset()` materializes the
    whole sealed span for a full GAME fit."""

    def __init__(self, out_dir: str):
        self.out_dir = str(out_dir)
        with open(os.path.join(self.out_dir, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        self.rows = int(self.manifest["sealed_rows"])
        self.chunk_rows = int(self.manifest["chunk_rows"])
        self.schema = self.manifest["schema"]

    def plan(self, row_multiple: int = 1):
        """ChunkPlan aligned 1:1 with the sealed chunk files."""
        from photon_ml_tpu_torch.data.streaming import ChunkPlan
        return ChunkPlan.build(self.rows, chunk_rows=self.chunk_rows,
                               row_multiple=row_multiple)

    def _chunk(self, index: int) -> dict:
        entry = self.manifest["chunks"][index]
        chunk = _read_chunk(os.path.join(self.out_dir, entry["name"]))
        if chunk["sha"] != entry["sha256"]:
            raise CompactionError(
                f"{entry['name']} does not match its manifest sha")
        return chunk

    def fetch(self, spec) -> Dict[str, np.ndarray]:
        """Host arrays for one ChunkSpec, padded to `spec.padded_rows`
        with zeros, so a padded row weighs nothing (the Prefetcher's fetch
        callback; pairs with `plan()`).  The JAX package's copy calls
        `pad_rows_host` without its `fill` and raises TypeError."""
        from photon_ml_tpu_torch.data.streaming import pad_rows_host
        start, stop = int(spec.start), int(spec.stop)
        first = start // self.chunk_rows
        last = (stop - 1) // self.chunk_rows
        parts = [self._chunk(i) for i in range(first, last + 1)]
        base = first * self.chunk_rows
        lo, hi = start - base, stop - base

        def cat(key, sub=None):
            if sub is None:
                arrs = [decode_array(p[key]) for p in parts]
            else:
                arrs = [decode_array(p[key][sub]) for p in parts]
            return np.concatenate(arrs)[lo:hi]

        out = {"labels": pad_rows_host(cat("labels"), spec.padded_rows, 0.0),
               "weights": pad_rows_host(cat("weights"), spec.padded_rows,
                                        0.0),
               "offsets": pad_rows_host(cat("offsets"), spec.padded_rows,
                                        0.0)}
        for s in self.schema["features"]:
            out[f"features.{s}"] = pad_rows_host(
                cat("features", s), spec.padded_rows, 0.0)
        return out

    def load_rows(self) -> dict:
        """Every sealed row as host arrays (features/ids/labels/weights/
        offsets/wall), in log order."""
        feats: Dict[str, List[np.ndarray]] = {}
        ids: Dict[str, List[str]] = {}
        labels, weights, offsets, wall = [], [], [], []
        for i in range(len(self.manifest["chunks"])):
            chunk = self._chunk(i)
            for s, enc in chunk["features"].items():
                feats.setdefault(s, []).append(decode_array(enc))
            for t, vals in chunk["ids"].items():
                ids.setdefault(t, []).extend(vals)
            labels.append(decode_array(chunk["labels"]))
            weights.append(decode_array(chunk["weights"]))
            offsets.append(decode_array(chunk["offsets"]))
            wall.append(decode_array(chunk["wall"]))
        if not labels:
            return {"rows": 0}
        return {
            "rows": self.rows,
            "features": {s: np.concatenate(v) for s, v in feats.items()},
            "ids": {t: np.asarray(v, dtype=object) for t, v in ids.items()},
            "labels": np.concatenate(labels),
            "weights": np.concatenate(weights),
            "offsets": np.concatenate(offsets),
            "wall": np.concatenate(wall),
        }

    def to_game_dataset(self, entity_vocabs=None, tail: Optional[dict] = None):
        """GameDataset over the sealed span (plus an optional unsealed
        `tail_rows()` suffix), interned against `entity_vocabs` (the
        incumbent model's entity spaces — unseen ids map to -1 exactly
        like the scoring path)."""
        from photon_ml_tpu_torch.data.game_data import build_game_dataset
        rows = self.load_rows()
        if rows["rows"] == 0 and tail is None:
            raise CompactionError("no sealed rows and no tail — nothing "
                                  "to build a dataset from")
        if rows["rows"] == 0:
            merged = tail
        elif tail is not None:
            merged = {
                "features": {s: np.concatenate([rows["features"][s],
                                                tail["features"][s]])
                             for s in rows["features"]},
                "ids": {t: np.concatenate([rows["ids"][t],
                                           np.asarray(tail["ids"][t],
                                                      dtype=object)])
                        for t in rows["ids"]},
                "labels": np.concatenate([rows["labels"], tail["labels"]]),
                "weights": np.concatenate([rows["weights"],
                                           tail["weights"]]),
                "offsets": np.concatenate([rows["offsets"],
                                           tail["offsets"]]),
                "wall": np.concatenate([rows["wall"], tail["wall"]]),
            }
        else:
            merged = rows
        ds = build_game_dataset(
            merged["labels"], merged["features"],
            offsets=merged["offsets"], weights=merged["weights"],
            entity_ids=merged["ids"], entity_vocabs=entity_vocabs)
        return ds, merged
