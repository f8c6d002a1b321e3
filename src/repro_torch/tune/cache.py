"""Persistent JSON cache of tuned decoupling configurations: the port's
copy of ``repro.tune.cache``.

Winners are keyed by ``(op, shape, dtype, backend, memory model)`` so a
config tuned for one problem size / memory system never leaks into
another.  The key has the reference's format, ``op|AxBxC|dtype|backend|
mem``, with two rules of the port's own:

* ``dtype`` is numpy's name (``float32``, ``bfloat16``, ``int32``),
  whatever form the caller passes (a ``torch.dtype``, a numpy dtype or
  a string);
* ``backend`` is ``cuda:sm<major><minor>`` (the card's compute
  capability, ``cuda:sm90`` on an H100), ``torch:cpu`` or, for the
  simulator, ``torch:sim``: never one of the reference's tags
  (``interpret``, ``cpu``, ``tpu``, ``gpu``, ``sim``), so no entry the
  JAX package writes into a shared file ever dispatches a port kernel.

The cache is a single JSON file (schema 1, atomic replace on save)
whose location is, in order of precedence:

  1. ``$REPRO_TUNE_CACHE`` (explicit path),
  2. ``$XDG_CACHE_HOME/repro/tune_cache.json``,
  3. ``~/.cache/repro/tune_cache.json``.

Dispatchers consult the process-wide :func:`default_cache` singleton;
lookups after the first are dictionary gets (no file is read or
stat'ed), so consulting the tuner on every kernel call is free.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

Config = Dict[str, Any]

__all__ = ["TuneCache", "CacheEntry", "make_key", "default_cache",
           "cache_path", "reset_default_cache"]

_SCHEMA_VERSION = 1


def cache_path() -> Path:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return Path(env).expanduser()
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg).expanduser() if xdg else Path.home() / ".cache"
    return base / "repro" / "tune_cache.json"


def _dtype_name(dtype) -> str:
    """numpy's name of ``dtype``: ``torch.bfloat16`` -> ``"bfloat16"``,
    ``np.dtype("int32")`` -> ``"int32"``; a string is kept as it is."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).rsplit(".", 1)[-1]


def make_key(op: str, shape: Sequence[int] | Tuple[int, ...], dtype,
             backend: str, mem: str) -> str:
    """Canonical cache key.  ``mem`` names the measurement model, e.g.
    ``wallclock``, ``wallclock:contenders=2`` or
    ``sim:fixed:lat=100:scale=small``."""
    shape_s = "x".join(str(int(s)) for s in shape) or "scalar"
    return "|".join((op, shape_s, _dtype_name(dtype), backend, mem))


@dataclasses.dataclass
class CacheEntry:
    config: Config
    score: float                  # lower is better (seconds or cycles)
    baseline_score: Optional[float] = None   # the seed config's score
    evals: int = 0
    note: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CacheEntry":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class TuneCache:
    """Load-once JSON store of :class:`CacheEntry`; ``save()`` re-reads
    the file and merges before the atomic replace, so concurrent tuner
    processes sharing one path keep each other's winners (best score
    wins on conflicts).  The read-merge-replace is not locked, so a
    write landing in the short window between another process's re-read
    and replace can still be lost — acceptable for tuning results,
    which the loser simply re-derives."""

    def __init__(self, path: Optional[Path | str] = None):
        self.path = Path(path) if path is not None else cache_path()
        self._entries: Optional[Dict[str, CacheEntry]] = None
        self.hits = 0
        self.misses = 0

    # -- loading / saving ---------------------------------------------------

    def _read_disk(self) -> Dict[str, CacheEntry]:
        entries: Dict[str, CacheEntry] = {}
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("version") == _SCHEMA_VERSION:
                for k, v in raw.get("entries", {}).items():
                    entries[k] = CacheEntry.from_json(v)
        except (OSError, ValueError, TypeError, AttributeError):
            pass  # missing or corrupt cache == empty cache
        return entries

    def _load(self) -> Dict[str, CacheEntry]:
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    def save(self) -> Path:
        entries = self._load()
        # merge entries another process persisted since our load: the
        # whole-file atomic replace would otherwise silently drop a
        # concurrent tuner's winners.  Disk-only keys are adopted; on a
        # key both sides tuned, the better (lower) score wins.
        for k, disk in self._read_disk().items():
            ours = entries.get(k)
            if ours is None or disk.score < ours.score:
                entries[k] = disk
        payload = {
            "version": _SCHEMA_VERSION,
            "entries": {k: e.to_json() for k, e in sorted(entries.items())},
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path

    # -- access -------------------------------------------------------------

    def get(self, key: str) -> Optional[CacheEntry]:
        e = self._load().get(key)
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def put(self, key: str, entry: CacheEntry, save: bool = True) -> None:
        self._load()[key] = entry
        if save:
            self.save()

    def __contains__(self, key: str) -> bool:
        return key in self._load()

    def __len__(self) -> int:
        return len(self._load())

    def keys(self):
        return self._load().keys()


_DEFAULT: Optional[TuneCache] = None
_DEFAULT_ENV: Optional[Tuple[Optional[str], ...]] = None


def _path_env() -> Tuple[Optional[str], ...]:
    """The environment :func:`cache_path` reads (``Path.home()`` reads
    ``$HOME``): comparing it is cheaper than building the path on every
    kernel call."""
    env = os.environ
    return (env.get("REPRO_TUNE_CACHE"), env.get("XDG_CACHE_HOME"),
            env.get("HOME"))


def default_cache() -> TuneCache:
    """Process-wide cache singleton, rebuilt whenever the environment
    that :func:`cache_path` reads changes (so ``$REPRO_TUNE_CACHE`` set
    per test isolates it)."""
    global _DEFAULT, _DEFAULT_ENV
    env = _path_env()
    if _DEFAULT is None or env != _DEFAULT_ENV:
        _DEFAULT, _DEFAULT_ENV = TuneCache(), env
    return _DEFAULT


def reset_default_cache() -> None:
    """Drop the singleton (tests; or after changing the env var)."""
    global _DEFAULT
    _DEFAULT = None
