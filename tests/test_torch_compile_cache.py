"""The port's persistent compile cache (``repro_torch.core.compile_cache``):
the reference's robustness contract, entries of plain data under a key
space of the port's own, and a warm process that lowers nothing."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import trace_engine as j_te
from repro_torch.core import SMConfig, compile_cache, cycles, trace_engine
from repro_torch.core.programs.fft import fft_program

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

FFT_CFG = SMConfig(n_threads=32, dim_x=32, shmem_depth=192,
                   max_steps=200_000)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache directory, active for the test, and empty in-process
    lowering caches before and after it."""
    monkeypatch.setattr(compile_cache, "_active", None)
    monkeypatch.setattr(compile_cache, "_resolved", False)
    monkeypatch.delenv("EGPU_CACHE_DIR", raising=False)
    _clear()
    cc = compile_cache.configure(str(tmp_path / "cache"))
    yield cc
    _clear()


def _clear():
    trace_engine.compile_cache_clear()
    cycles._trace_cached.cache_clear()


def _words():
    return tuple(int(w) for w in fft_program(64).words)


def _entries(cc) -> dict:
    """``{kind: [file, ...]}`` of the entries on disk."""
    out: dict = {}
    for p in sorted(Path(cc.path).rglob("*.pkl")):
        out.setdefault(p.name.split("-", 1)[0], []).append(p)
    return out


def _lower():
    """Lower FFT-64 as a launch does: its trace for the timing model, then
    its megakernel plan (over its schedule)."""
    cycles.program_trace(_words(), FFT_CFG.n_threads,
                         imem_depth=FFT_CFG.imem_depth,
                         max_steps=FFT_CFG.max_steps)
    return trace_engine.compile_megakernel(_words(), FFT_CFG)


def _plan_view(plan):
    segs = [(s.n_folded, len(s.residual), [r for r, _ in s.final_consts],
             [(k, row.fields, c and [r for r, _ in c])
              for k, row, _, c in s.residual])
            for s in plan.segments]
    return (plan.sched.table.tolist(), plan.barriers.tolist(),
            [(k, p if k == "fused" else p.fields) for k, p in plan.items],
            segs, plan.stats(), plan.sched.trace)


def _write(path, entry):
    path.write_bytes(pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL))


def _corrupt(kind, path, key):
    good = pickle.loads(path.read_bytes())
    if kind == "corrupt":
        path.write_bytes(b"\x00not a pickle\xff" * 3)
    elif kind == "truncated":
        path.write_bytes(path.read_bytes()[:40])
    elif kind == "foreign-magic":
        _write(path, dict(good, magic="egpu-compile-cache"))
    elif kind == "wrong-format":
        _write(path, dict(good, format=good["format"] + 1))
    elif kind == "wrong-key":
        _write(path, dict(good, key=key[:-1] + "0"))
    elif kind == "foreign-class":
        # a value that needs a class outside plain data to unpickle
        _write(path, dict(good, value=FFT_CFG))
    else:
        raise AssertionError(kind)


BAD = ("corrupt", "truncated", "foreign-magic", "wrong-format", "wrong-key",
       "foreign-class")


@pytest.mark.parametrize("kind", ("trace", "lowering", "megakernel"))
@pytest.mark.parametrize("bad", BAD)
def test_bad_entry_is_a_counted_miss_removed_and_rewritten(cache, kind, bad):
    want = _plan_view(_lower())
    (path,) = _entries(cache)[kind]
    key = path.stem
    _corrupt(bad, path, key)
    _clear()
    before = dict(cache.stats.by_kind[kind])
    assert _plan_view(_lower()) == want
    after = cache.stats.by_kind[kind]
    assert after["misses"] == before["misses"] + 1
    assert after["errors"] == before["errors"] + 1
    assert after["hits"] == before["hits"]
    assert after["stores"] == before["stores"] + 1       # rewritten
    assert cache.get(key) is not None                     # and readable
    assert not list(Path(cache.path).rglob("*.tmp"))


def test_bad_entry_with_no_caller_to_rewrite_it_is_removed(cache):
    _lower()
    (path,) = _entries(cache)["trace"]
    path.write_bytes(b"garbage")
    assert cache.get(path.stem) is None
    assert not path.exists()
    assert cache.stats.errors == 1


def test_warm_lowering_hits_every_kind_and_equals_the_cold_one(cache):
    want = _plan_view(_lower())
    assert cache.stats.misses == 3 and cache.stats.stores == 3
    assert sorted(_entries(cache)) == ["lowering", "megakernel", "trace"]
    _clear()
    assert _plan_view(_lower()) == want
    s = compile_cache.stats()
    assert (s["hits"], s["misses"], s["errors"], s["stores"]) == (3, 3, 0, 3)
    for kind in ("trace", "lowering", "megakernel"):
        assert s["by_kind"][kind] == dict(hits=1, misses=1, errors=0,
                                          stores=1)


def test_put_leaves_no_temporary_file_and_stores_plain_data(cache):
    _lower()
    assert not list(Path(cache.path).rglob("*.tmp"))
    for paths in _entries(cache).values():
        for p in paths:
            # the plain unpickler opens every entry the port writes
            entry = compile_cache._PlainUnpickler(p.open("rb")).load()
            assert entry["magic"] == compile_cache._MAGIC
            assert entry["key"] == p.stem


@pytest.mark.parametrize("kind", ("lowering", "megakernel"))
def test_stale_layout_is_a_miss(cache, kind):
    want = _plan_view(_lower())
    (path,) = _entries(cache)[kind]
    entry = pickle.loads(path.read_bytes())
    if kind == "lowering":
        # an entry from before a FIELDS extension: no predicate columns
        value = dict(entry["value"])
        value["cols"] = {f: c for f, c in value["cols"].items()
                         if f not in ("pen", "preg", "pneg")}
    else:
        # barrier bits of another length than the schedule's rows
        spans, barriers, segs = entry["value"]
        value = (spans, barriers[:-1], segs)
    _write(path, dict(entry, value=value))
    _clear()
    assert _plan_view(_lower()) == want
    assert cache.stats.by_kind[kind]["errors"] == 1
    assert cache.stats.by_kind[kind]["stores"] == 2


def test_key_space_is_the_ports_own():
    from repro.core import compile_cache as j_cc

    words = _words()
    for kind in ("trace", "lowering"):
        k = compile_cache.key_for(kind, words, FFT_CFG)
        assert k.startswith(kind + "-")
        assert k[-64:] != j_cc.key_for(kind, words, FFT_CFG)
    assert compile_cache.key_for("megakernel", words, FFT_CFG,
                                 engine="megakernel") \
        != compile_cache.key_for("megakernel", words, FFT_CFG)


def test_configure_none_disables_the_cache(cache):
    compile_cache.configure(None)
    assert compile_cache.active() is None
    assert compile_cache.stats() is None
    compile_cache.store("trace-" + "0" * 64, (True, 1, np.zeros((0, 5))))
    assert compile_cache.load("trace-" + "0" * 64) is None
    _lower()
    assert not _entries(cache)


def test_env_dir_is_resolved_on_first_use(tmp_path, monkeypatch):
    d = tmp_path / "lazy"
    monkeypatch.setattr(compile_cache, "_active", None)
    monkeypatch.setattr(compile_cache, "_resolved", False)
    monkeypatch.setenv("EGPU_CACHE_DIR", str(d))
    assert not d.exists()
    cc = compile_cache.active()
    assert cc is not None and cc.path == str(d) and d.is_dir()
    # importing the package touches nothing
    d2 = tmp_path / "untouched"
    out = subprocess.run(
        [sys.executable, "-c", "import repro_torch, repro_torch.core, "
         "repro_torch.core.programs; print('ok')"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": SRC, "EGPU_CACHE_DIR": str(d2)})
    assert out.returncode == 0, out.stderr
    assert not d2.exists()
    monkeypatch.setattr(compile_cache, "_active", None)
    monkeypatch.setattr(compile_cache, "_resolved", False)


def test_compile_cache_info_and_clear_behave_as_the_references():
    from repro.core.assembler import assemble as j_assemble
    from repro.core.machine import SMConfig as JSMConfig
    from repro.core.programs.fft import fft_asm

    words = j_assemble(fft_asm(64)).words
    seen = []
    for te, cfg in ((j_te, JSMConfig(n_threads=32, dim_x=32,
                                     shmem_depth=192)),
                    (trace_engine, SMConfig(n_threads=32, dim_x=32,
                                            shmem_depth=192))):
        te.compile_cache_clear()
        trail = [te.compile_cache_info()]
        te.compile_program(words, cfg)
        te.compile_program(words, cfg)
        trail.append(te.compile_cache_info())
        te.compile_cache_clear()
        trail.append(te.compile_cache_info())
        seen.append([(i.hits, i.misses, i.maxsize, i.currsize)
                     for i in trail])
    assert seen[1] == seen[0] == [(0, 0, 256, 0), (1, 1, 256, 1),
                                  (0, 0, 256, 0)]


# ---------------------------------------------------------------------------
# fresh processes
# ---------------------------------------------------------------------------

_REFERENCE_WRITER = """
import sys
sys.path.insert(0, {src!r})
from repro.core import compile_cache, trace_engine
from repro.core.machine import SMConfig
from repro.core.programs.fft import fft_program
from repro.core.programs.qrd import qrd_program
compile_cache.configure({cache!r})
trace_engine.compile_program(fft_program(64), SMConfig(n_threads=32,
                             dim_x=32, shmem_depth=1024, imem_depth=1024))
trace_engine.compile_program(qrd_program(), SMConfig(
    shmem_depth=1024, imem_depth=1024, max_steps=200_000))
print(compile_cache.stats()["stores"])
"""

_PORT_READER = """
import builtins, json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
opened = []
_open = builtins.open
def spy(f, *a, **k):
    opened.append(str(f))
    return _open(f, *a, **k)
builtins.open = spy
sys.path.insert(0, {src!r})
from repro_torch.core import compile_cache, trace_engine
from repro_torch.core.machine import SMConfig
from repro_torch.core.programs.fft import fft_program
from repro_torch.core.programs.qrd import qrd_program
compile_cache.configure({cache!r})
for prog, cfg in ((fft_program(64), SMConfig(n_threads=32, dim_x=32,
                   shmem_depth=1024, imem_depth=1024)),
                  (qrd_program(), SMConfig(shmem_depth=1024,
                   imem_depth=1024, max_steps=200_000))):
    trace_engine.compile_megakernel(prog, cfg)
bad = [k for k, v in sys.modules.items() if v is not None
       and (k == "jax" or k.startswith(("jax.", "repro.")))]
print(json.dumps(dict(stats=compile_cache.stats(), opened=opened, bad=bad)))
"""


def _run(code: str, env=None) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "EGPU_JAX_CACHE": "0", **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_port_never_reads_the_references_entries_in_a_shared_dir(tmp_path):
    cache = str(tmp_path / "shared")
    assert int(_run(_REFERENCE_WRITER.format(src=SRC, cache=cache))) == 4
    ref_files = {str(p) for p in Path(cache).rglob("*.pkl")}
    assert len(ref_files) == 4
    got = json.loads(_run(_PORT_READER.format(src=SRC, cache=cache)))
    s = got["stats"]
    assert s["hits"] == 0 and s["errors"] == 0 and s["misses"] == 6, s
    assert not ref_files & set(got["opened"])
    assert got["bad"] == []
    # the reference's entries are still there, untouched
    assert ref_files <= {str(p) for p in Path(cache).rglob("*.pkl")}


_LAUNCH = """
import json, sys, time
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.core import compile_cache
from repro_torch.core.programs import launch_fft_qrd, mixed_device
rng = np.random.default_rng(7)
xs = (rng.standard_normal((4, 64))
      + 1j * rng.standard_normal((4, 64))).astype(np.complex64)
As = rng.standard_normal((2, 16, 16)).astype(np.float32)
res = launch_fft_qrd(xs, As, device=mixed_device(64, n_sms=2,
                                                 backend="cpu"))[3]
np.savez({out!r}, regs=res.regs.numpy(), shmem=res.shmem.numpy(),
         gmem=res.gmem.numpy(), oob=res.oob.numpy(), engine=res.engine,
         profile=json.dumps(res.profile(), sort_keys=True))
print(json.dumps(compile_cache.stats()))
"""


def test_warm_process_lowers_nothing_and_launches_the_same(tmp_path):
    env = {"EGPU_CACHE_DIR": str(tmp_path / "cache")}
    outs = [tmp_path / "cold.npz", tmp_path / "warm.npz"]
    cold, warm = (json.loads(_run(_LAUNCH.format(src=SRC, out=str(o)), env))
                  for o in outs)
    assert cold["hits"] == 0 and cold["stores"] > 0 and cold["errors"] == 0
    assert warm["misses"] == 0 and warm["errors"] == 0 and warm["stores"] == 0
    for kind in ("trace", "lowering", "megakernel"):
        assert warm["by_kind"][kind]["hits"] > 0, warm
    a, b = (np.load(o) for o in outs)
    assert str(a["engine"]) == "megakernel"
    for k in ("regs", "shmem", "gmem", "oob"):
        assert np.array_equal(a[k], b[k]), k
    assert str(a["profile"]) == str(b["profile"])


def test_core_exports_every_name_of_the_references_core():
    import repro.core as j_core
    import repro_torch.core as t_core

    assert set(j_core.__all__) <= set(t_core.__all__)
    for name in t_core.__all__:
        assert hasattr(t_core, name), name
    assert t_core.compile_cache is compile_cache
