"""Tiered offload: an object-store abstraction for cold segments.

Sealed columnar segments are immutable, which makes them safe to move
wholesale to cheaper storage.  The manifest stays the source of truth
(a segment listed under ``cold`` lives in the object store, not the
local directory); ``scan()`` fetches cold segments transparently, and
a fetch failure dead-letters under ``store_cold_unavailable`` and
skips the segment instead of wedging the reader.

``LocalDirObjectStore`` is the reference backend — a directory of
objects with atomic puts — but anything with put/get/delete/exists
plugs in (an S3 client wrapper is the obvious production drop-in).
"""
from __future__ import annotations

import os
import tempfile
from typing import List


class ObjectStoreError(Exception):
    """An object-store operation failed (missing key, I/O error)."""


class ObjectStore:
    """Minimal blob-store surface the tiering layer needs."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """Return the object's bytes; raise ObjectStoreError if absent."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove the object (missing keys are not an error)."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self) -> List[str]:
        raise NotImplementedError


class LocalDirObjectStore(ObjectStore):
    """Object store backed by a local directory; puts are atomic
    (tmp + fsync + rename) so a crash mid-put never leaves a torn
    object behind."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if "/" in key or key.startswith("."):
            raise ObjectStoreError(f"invalid object key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".put-")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise ObjectStoreError(f"put {key!r} failed: {e}") from e

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except OSError as e:
            raise ObjectStoreError(f"get {key!r} failed: {e}") from e

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise ObjectStoreError(f"delete {key!r} failed: {e}") from e

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self) -> List[str]:
        return sorted(n for n in os.listdir(self.root)
                      if not n.startswith("."))
