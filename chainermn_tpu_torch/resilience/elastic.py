"""World manifests and snapshot integrity (port of the manifest half of
``chainermn_tpu/resilience/elastic.py``).

Every snapshot carries a JSON manifest naming the world that wrote it
(``world_size``, ``process_count``, the sync axes) and a sha256 digest
and byte count of every file, written inside the snapshot's temporary
directory so that manifest and payload commit in one rename.
:func:`verify_snapshot` lets the checkpoint inventory drop a torn or
corrupt snapshot, so the newest common step falls back to the previous
one instead of failing at load.

Resharding a snapshot onto a world of another size (the JAX module's
``reshard_state`` and ``reshard_iterator_state``) waits for ROADMAP
Queue 1, 'Resilience': both raise ``NotImplementedError``, so a resume
at another world size fails loudly rather than load a wrong state.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

MANIFEST_FORMAT = 1
MANIFEST_NAME = "manifest.json"

_RESHARD = "ROADMAP Queue 1, 'Resilience'"


def world_manifest(comm, *, files: Optional[dict] = None) -> dict:
    """The manifest of a snapshot: the communicator's
    ``world_descriptor()`` and, optionally, the per-file digests."""
    m = {"format": MANIFEST_FORMAT}
    m.update(comm.world_descriptor())
    if files is not None:
        m["files"] = files
    return m


def manifest_sibling(step_dir: str) -> str:
    """The manifest beside a step directory whose contents belong to
    another writer: ``<step_dir>.manifest.json`` (the step scan's
    ``step_<digits>`` never matches it)."""
    return step_dir.rstrip("/") + ".manifest.json"


def write_manifest(manifest: dict, path: str) -> None:
    """Atomic JSON write (tmp + rename): a crash mid-write never leaves a
    torn manifest."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


_INVALID_MANIFEST = object()  # present on disk but unreadable


def _read_manifest_file(step_dir: str):
    """The step's manifest, inside the directory first, then beside it:
    a dict; ``None`` where there is none (a snapshot older than
    manifests); :data:`_INVALID_MANIFEST` where one is present but torn,
    which marks the snapshot corrupt."""
    found_broken = False
    for path in (os.path.join(step_dir, MANIFEST_NAME),
                 manifest_sibling(step_dir)):
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            found_broken = True
    return _INVALID_MANIFEST if found_broken else None


def read_world_manifest(step_dir: str) -> Optional[dict]:
    """The step's manifest, or None when absent or invalid."""
    m = _read_manifest_file(step_dir)
    return m if isinstance(m, dict) else None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def file_digests(root: str, *, exclude=(MANIFEST_NAME,)) -> dict:
    """``{relpath: {"bytes": n, "sha256": hex}}`` of every file under
    ``root`` but the manifest, which cannot hold its own digest."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel in exclude:
                continue
            out[rel] = {"bytes": os.path.getsize(full),
                        "sha256": _sha256_file(full)}
    return out


def snapshot_signature(step_dir: str) -> tuple:
    """A stat-based fingerprint of the files a snapshot's manifest
    lists, to memoize :func:`verify_snapshot` (a committed snapshot
    never changes, so one full hash per directory state is enough)."""
    m = read_world_manifest(step_dir)
    files = (m or {}).get("files")
    if not files:
        return ("nofiles",)
    sig = []
    for rel in sorted(files):
        p = os.path.join(step_dir, rel)
        try:
            st = os.stat(p)
            sig.append((rel, st.st_size, st.st_mtime_ns))
        except OSError:
            sig.append((rel, -1, -1))
    return tuple(sig)


def verify_snapshot(step_dir: str, manifest: Optional[dict] = None) -> bool:
    """True iff every file the manifest lists exists with its recorded
    byte count and sha256.  A snapshot without a manifest, or whose
    manifest lists no files, verifies by its presence; a torn manifest
    fails."""
    m = manifest if manifest is not None else _read_manifest_file(step_dir)
    if m is _INVALID_MANIFEST:
        return False
    files = (m or {}).get("files")
    if not files:
        return True
    for rel, info in files.items():
        p = os.path.join(step_dir, rel)
        if not os.path.isfile(p):
            return False
        try:
            if os.path.getsize(p) != int(info["bytes"]):
                return False
            if _sha256_file(p) != info["sha256"]:
                return False
        except (OSError, KeyError, TypeError, ValueError):
            return False
    return True


def reshard_state(state, like, old_world: int, new_world: int, *,
                  label: str = "state"):
    """Re-partition a snapshot of ``old_world`` ranks onto ``new_world``
    (not ported)."""
    raise NotImplementedError(
        f"{label} was saved at world size {old_world} and this world has "
        f"{new_world} ranks: resharding a checkpoint is not ported yet, "
        f"see {_RESHARD}")


def reshard_iterator_state(state, old_pc: int, new_pc: int):
    """Rescale an iterator's cursor onto another process count (not
    ported)."""
    raise NotImplementedError(
        f"an iterator saved over {old_pc} processes cannot resume over "
        f"{new_pc}: resharding is not ported yet, see {_RESHARD}")
