"""Persistent on-disk compile cache: a fresh process skips the host
lowering.

The in-process lowering caches (``cycles._trace_cached``,
``trace_engine._compile_cached`` and ``trace_engine._megakernel_cached``)
make repeated launches free within one process, but a fresh process
re-walks every program trace, re-decodes every schedule and re-runs the
megakernel plan's partial evaluation before its first wave. This module
is the tier behind them: a content-addressed store on disk, keyed by a
sha256 over

    (package tag, format version, artifact kind, program words,
     SMConfig fields, backend, engine)

Three artifact kinds ship:

  * ``"trace"`` — the issued-trace walk (``cycles.program_trace``);
  * ``"lowering"`` — the trace and the decoded schedule columns
    (``trace_engine.compile_program``);
  * ``"megakernel"`` — a megakernel plan's host parts: its items, the
    barrier bits and each fused segment's partial evaluation
    (``trace_engine.compile_megakernel``; keyed with
    ``engine="megakernel"``). The plan's uploaded row tables are device
    state and are never stored, so an entry written beside a card loads
    on a host without one and the other way round.

Entries hold plain data only — tuples, ints, bools, strings and numpy
arrays — and each kind rebuilds its objects on load. Entries are read
through an unpickler that resolves only a few builtins and numpy's array
helpers: an entry that names any other class is corrupt. Every key hashes
this package's own tag and every entry carries this package's own magic,
so an entry written by another package sharing ``EGPU_CACHE_DIR`` is
never opened (its file name differs) and could not be read if it were.

The cache is OPT-IN (tests and casual runs must not litter the
filesystem): activate it with ``configure(path)`` or by exporting
``EGPU_CACHE_DIR``, which is read on first use, never at import.
Robustness: a missing, truncated, foreign, wrong-version, wrong-key or
stale-layout entry is a MISS (all but a missing one are also counted in
``errors``) and is removed, so the caller recomputes and ``put``
rewrites it; ``put`` writes a temporary file and renames it into place;
the cache never raises into a launch. ``stats()`` gives the counters,
in total and per kind, so tests and the chip smoke can show an entry was
served.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Any, Callable

_ENV = "EGPU_CACHE_DIR"
_TAG = "repro_torch"
# bump with any change to a cached layout (a kind's payload fields)
_FORMAT = 1
_MAGIC = "repro_torch-compile-cache"

# what an entry may name: a few builtins, and numpy's array, dtype and
# scalar reconstructors (under ``numpy.core`` or ``numpy._core``)
_SAFE_BUILTINS = frozenset(("set", "frozenset", "complex", "slice",
                            "bytearray"))
_SAFE_NUMPY = frozenset(("dtype", "ndarray", "_reconstruct", "scalar",
                         "_frombuffer"))


class _PlainUnpickler(pickle.Unpickler):
    """Resolves only plain data: any other class makes the entry corrupt."""

    def find_class(self, module: str, name: str):
        if (module == "builtins" and name in _SAFE_BUILTINS) or (
                (module == "numpy" or module.startswith("numpy."))
                and name in _SAFE_NUMPY):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"cache entry names {module}.{name}")


def _kind_of(key: str) -> str:
    return key.split("-", 1)[0]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    errors: int = 0      # unreadable, foreign or stale entries (also misses)
    stores: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)

    def count(self, key: str, field: str) -> None:
        setattr(self, field, getattr(self, field) + 1)
        per = self.by_kind.setdefault(
            _kind_of(key), dict(hits=0, misses=0, errors=0, stores=0))
        per[field] += 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CompileCache:
    """One on-disk cache directory of plain-data lowering artifacts."""

    def __init__(self, path: str):
        self.path = str(path)
        self.stats = CacheStats()
        os.makedirs(self.path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key[-64:][:2], key + ".pkl")

    def get(self, key: str, check: Callable[[Any], bool] | None = None):
        """The cached value, or None on a miss. Any failure to read or
        validate the entry — a missing file, a truncated or foreign
        pickle, another magic, format or key, a class outside plain data,
        or a value ``check`` rejects (a stale layout) — is a miss; all but
        a missing file also count as errors and remove the entry, which
        the caller's ``put`` rewrites."""
        f = self._file(key)
        try:
            with open(f, "rb") as fh:
                entry = _PlainUnpickler(fh).load()
            if (not isinstance(entry, dict)
                    or entry.get("magic") != _MAGIC
                    or entry.get("format") != _FORMAT
                    or entry.get("key") != key
                    or "value" not in entry):
                raise ValueError("malformed cache entry")
            if check is not None and not check(entry["value"]):
                raise ValueError("stale cache entry layout")
        except FileNotFoundError:
            self.stats.count(key, "misses")
            return None
        except Exception:
            self.stats.count(key, "errors")
            self.stats.count(key, "misses")
            try:
                os.unlink(f)             # quarantine: the next put rewrites
            except OSError:
                pass
            return None
        self.stats.count(key, "hits")
        return entry["value"]

    def put(self, key: str, value) -> None:
        """Persist ``value`` atomically (a temporary file renamed into
        place); failures are silent: the cache speeds a launch up and is
        never needed for a correct one."""
        f = self._file(key)
        try:
            os.makedirs(os.path.dirname(f), exist_ok=True)
            blob = pickle.dumps({"magic": _MAGIC, "format": _FORMAT,
                                 "key": key, "value": value},
                                protocol=pickle.HIGHEST_PROTOCOL)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(f),
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, f)       # atomic on POSIX
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.stats.count(key, "stores")
        except Exception:
            pass


# the active cache (None = disabled); resolved lazily from the
# environment, so importing the package never touches the filesystem
_active: CompileCache | None = None
_resolved = False


def key_for(kind: str, words, cfg, *, backend: str = "-",
            engine: str = "-") -> str:
    """The key of one artifact: ``"<kind>-<sha256>"`` over (package tag,
    format, kind, program words, ``repr(cfg)``, backend, engine). ``cfg``
    may be an SMConfig or any object with a deterministic repr; backend
    and engine default to fixed tags for artifacts that depend on
    neither."""
    h = hashlib.sha256()
    h.update(repr((_TAG, _FORMAT, kind, tuple(int(w) for w in words),
                   repr(cfg), backend, engine)).encode())
    return f"{kind}-{h.hexdigest()}"


def configure(path: str | None) -> CompileCache | None:
    """Activate the cache at ``path`` (None disables it)."""
    global _active, _resolved
    _resolved = True
    _active = None if path is None else CompileCache(path)
    return _active


def active() -> CompileCache | None:
    """The configured cache, resolving ``EGPU_CACHE_DIR`` on first use."""
    global _resolved
    if not _resolved:
        _resolved = True
        env = os.environ.get(_ENV, "").strip()
        if env:
            configure(env)
    return _active


def load(key: str, check: Callable[[Any], bool] | None = None):
    cc = active()
    return cc.get(key, check) if cc is not None else None


def store(key: str, value) -> None:
    cc = active()
    if cc is not None:
        cc.put(key, value)


def stats() -> dict | None:
    cc = active()
    return cc.stats.as_dict() if cc is not None else None


# ---------------------------------------------------------------------------
# layout checks shared by the kinds
# ---------------------------------------------------------------------------

def is_array(x, dtype, ndim: int, length: int | None = None) -> bool:
    """Whether ``x`` is a numpy array of ``dtype`` and rank ``ndim`` (and
    ``length`` rows, when given)."""
    import numpy as np

    return (isinstance(x, np.ndarray) and x.dtype == np.dtype(dtype)
            and x.ndim == ndim
            and (length is None or x.shape[0] == length))


def is_record(x, n: int) -> bool:
    """Whether ``x`` is a tuple of ``n`` fields."""
    return isinstance(x, tuple) and len(x) == n
