"""Durable small-file writes: the atomic write+fsync helpers that model
persistence and checkpoints use (port of photon_ml_tpu/utils/durable.py).

A bare `open(path, "w")` torn by a crash leaves a half-written file that a
later load then trusts; every metadata and state file instead goes
tmp -> flush -> fsync -> atomic `os.replace` -> directory fsync, so at any
instant the path holds either the complete old content or the complete
new content.  `write_manifest` layers the checkpoint completeness marker
on top: every data file fsynced, then a per-file size+sha256
manifest.json written LAST with the same atomic discipline
(game/coordinate_descent.py's resume verifies it).

On a multi-process run every process would race the same `state.json`
replace, so the helpers are no-ops on non-primary processes
(`parallel/multihost.py::is_primary`, process id != 0); pass
``all_process=True`` for genuinely per-process files (the multihost
watchdog's heartbeats).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional


def _is_primary() -> bool:
    # lazy import: multihost reads only its own state and the environment
    from photon_ml_tpu_torch.parallel import multihost
    return multihost.is_primary()


def fsync_file(path: str) -> None:
    """Best-effort fsync of an existing file (some filesystems refuse;
    durability is then whatever the mount gives)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def fsync_dir(path: str) -> None:
    """Directory fsync: makes a rename or creation itself durable."""
    fsync_file(path)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def atomic_write_text(path: str, text: str, fsync: bool = True,
                      before_replace: Optional[Callable[[], None]] = None,
                      all_process: bool = False) -> None:
    """Write `text` to `path` via tmp + fsync + atomic replace.  A crash at
    any point leaves either the old complete file or the new complete file,
    plus at worst a `{path}.tmp`.  `before_replace` runs between the fsync
    and the rename: the hook checkpointing uses to place its
    `checkpoint.fsync` fault-injection site at the canonical torn-write
    instant.  No-op on non-primary processes unless `all_process`."""
    if not all_process and not _is_primary():
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    if before_replace is not None:
        before_replace()
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def atomic_write_json(path: str, obj, indent: int = 2, fsync: bool = True,
                      before_replace: Optional[Callable[[], None]] = None,
                      all_process: bool = False) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent), fsync=fsync,
                      before_replace=before_replace, all_process=all_process)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True,
                       all_process: bool = False) -> None:
    """Binary twin of atomic_write_text: tmp + fsync + atomic replace, so a
    crash mid-write leaves either the old or the new complete file."""
    if not all_process and not _is_primary():
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def append_text(path: str, text: str, fsync: bool = True,
                all_process: bool = False) -> None:
    """Durable append for record logs.  Appends are not atomic the way
    replace is: a crash mid-append leaves a torn tail, so every appended
    record must carry its own integrity check.  The fsync makes every
    record that did append completely survive the crash."""
    if not all_process and not _is_primary():
        return
    with open(path, "a") as f:
        f.write(text)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def write_marker(path: str, fsync: bool = True,
                 all_process: bool = False) -> None:
    """Create an empty completion marker (`_SUCCESS`) durably: the directory
    is fsynced after creation, so the marker never becomes durable before
    the data it vouches for."""
    if not all_process and not _is_primary():
        return
    with open(path, "w"):
        pass
    if fsync:
        fsync_file(path)
        fsync_dir(os.path.dirname(path) or ".")


def write_manifest(dirpath: str, all_process: bool = False) -> None:
    """Scan `dirpath` and write manifest.json LAST (tmp + rename + fsync):
    the completeness marker a checkpoint resume verifies.  Every data file
    is fsynced first, so a verifying manifest implies durable contents."""
    if not all_process and not _is_primary():
        return
    files = {}
    for root, _, names in os.walk(dirpath):
        for fn in sorted(names):
            if fn in ("manifest.json", "manifest.json.tmp"):
                continue
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, dirpath)
            fsync_file(p)
            files[rel] = {"bytes": os.path.getsize(p),
                          "sha256": file_sha256(p)}
    atomic_write_json(os.path.join(dirpath, "manifest.json"),
                      {"format_version": 1, "files": files}, indent=1)
