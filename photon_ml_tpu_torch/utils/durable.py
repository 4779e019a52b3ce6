"""Durable small-file writes (port of the helpers of
photon_ml_tpu/utils/durable.py that model persistence uses).

A bare `open(path, "w")` torn by a crash leaves a half-written file that a
later load then trusts; every metadata file of a saved model instead goes
tmp -> flush -> fsync -> atomic `os.replace` -> directory fsync, so at any
instant the path holds either the complete old content or the complete
new content.

The port runs one process, so there is no multi-writer guard here; the
checkpoint helpers (`write_manifest`, `append_text`, ...) belong to
checkpoints and resume (ROADMAP.md queue A item 14).
"""
from __future__ import annotations

import json
import os


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


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    """Write `text` to `path` via tmp + fsync + atomic replace.  A crash at
    any point leaves either the old complete file or the new complete file,
    plus at worst a `{path}.tmp`."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def atomic_write_json(path: str, obj, indent: int = 2, fsync: bool = True) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent), fsync=fsync)


def write_marker(path: str, fsync: bool = True) -> None:
    """Create an empty completion marker (`_SUCCESS`) durably: the directory
    is fsynced after creation, so the marker never becomes durable before
    the data it vouches for."""
    with open(path, "w"):
        pass
    if fsync:
        fsync_file(path)
        fsync_dir(os.path.dirname(path) or ".")
