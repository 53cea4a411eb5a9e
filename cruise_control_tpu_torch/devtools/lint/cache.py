"""Incremental analysis cache (``.cclint_cache/``, safe to delete).

One pickle store maps file **content hashes** to the expensive per-file
products: the extracted :class:`~graph.ModuleSummary` and the complete
per-file-rule finding list.  Keying on content (not path) makes entries
position-independent — the test fixtures that copy package files into
tmp dirs hit the same entries — and means a warm package-wide run
parses NOTHING that did not change.

The store is salted with a hash of the lint package's own sources
(:func:`graph.lint_sources_salt`): editing any rule, the extractor, or
the driver drops every entry at once, so a stale cache can never mask a
rule change.  Writes are atomic (tmp + ``os.replace``); any read error
degrades to an empty cache, never to a crash."""

from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import tempfile
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.devtools.lint.graph import ModuleSummary

#: findings are stored path-free: (rule, line, col, message)
CachedFinding = Tuple[str, int, int, str]


@dataclasses.dataclass
class CacheEntry:
    summary: ModuleSummary            # path/module fields are re-stamped
    findings: List[CachedFinding]     # ALL per-file rules' findings


class CacheStore:
    STORE_NAME = "store.pkl"

    def __init__(self, directory: Optional[pathlib.Path], salt: str):
        self.directory = directory
        self.salt = salt
        self.entries: Dict[str, CacheEntry] = {}
        self.hits = 0
        self.dirty = False
        self._load()

    def _path(self) -> Optional[pathlib.Path]:
        return None if self.directory is None \
            else self.directory / self.STORE_NAME

    def _load(self) -> None:
        path = self._path()
        if path is None or not path.exists():
            return
        try:
            with open(path, "rb") as fh:
                payload = pickle.load(fh)
            if payload.get("salt") == self.salt:
                self.entries = payload["entries"]
        except Exception:
            self.entries = {}  # corrupt/foreign store: rebuild silently

    def get(self, content_hash: str) -> Optional[CacheEntry]:
        entry = self.entries.get(content_hash)
        if entry is not None:
            self.hits += 1
        return entry

    def put(self, content_hash: str, entry: CacheEntry) -> None:
        self.entries[content_hash] = entry
        self.dirty = True

    def save(self) -> None:
        path = self._path()
        if path is None or not self.dirty:
            return
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                       prefix=".store-")
            with os.fdopen(fd, "wb") as fh:
                pickle.dump({"salt": self.salt, "entries": self.entries},
                            fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception:
            pass  # a cache that cannot persist is just a cold cache
