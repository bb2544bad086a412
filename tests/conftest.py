"""Test-suite bootstrap.

Two jobs:

1. Make ``import repro`` work without an installed package (the repo uses a
   src/ layout; CI and the tier-1 command both set PYTHONPATH=src, but a bare
   ``pytest`` from the repo root should work too).

2. Degrade gracefully when ``hypothesis`` is not installed (it is a dev-only
   dependency, declared in requirements-dev.txt). Five test modules import
   ``hypothesis`` at module scope; without this shim the whole collection
   dies with ModuleNotFoundError. The shim registers a stand-in module whose
   ``@given`` marks the test as skipped, so the plain unit tests in those
   modules still run.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

_SRC = Path(__file__).resolve().parent.parent / "src"
if _SRC.is_dir() and str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "scheduler: block-scheduler + golden cycle-model regression tests "
        "(CI runs them standalone via `pytest -m scheduler`)")
    config.addinivalue_line(
        "markers",
        "conformance: engine x schedule x backend x n_sms cross-engine "
        "conformance matrix (CI runs it standalone via "
        "`pytest -m conformance`)")
    config.addinivalue_line(
        "markers",
        "packing: wave-packing property suite — pad-minimality, "
        "packing-invariance, dynamic<=static under the packed wave rule "
        "(CI runs it standalone via `pytest -m packing`)")
    config.addinivalue_line(
        "markers",
        "serve: serving-layer suite — decode-engine budget/admission "
        "regressions and the LaunchServer continuous-batching front door "
        "(CI runs it standalone via `pytest -m serve`)")
    config.addinivalue_line(
        "markers",
        "divergence: SIMT predication suite — SETP/SELP semantics, "
        "masked-lane never-mutate properties, and predicated-program "
        "fuzz differentially vs the step oracle "
        "(CI runs it standalone via `pytest -m divergence`)")
    config.addinivalue_line(
        "markers",
        "fleet: multi-device fleet conformance — fleet(n) bit-identity "
        "to the single device, NUMA cycle charges, shard_map placement "
        "(CI runs it standalone under "
        "XLA_FLAGS=--xla_force_host_platform_device_count=4 via "
        "`pytest -m fleet`)")
    config.addinivalue_line(
        "markers",
        "cuda: runs the PyTorch/CUDA port's kernels on a CUDA device; skips "
        "where none is present (run on the card via `pytest -m cuda`)")

try:
    import hypothesis  # noqa: F401
except ImportError:
    hyp = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")

    def given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements-dev.txt)"
            )(fn)
        return deco

    def settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    def _strategy_stub(*_a, **_k):
        # self-returning so decorator-style uses (@st.composite) and chained
        # calls all collect cleanly
        return _strategy_stub

    def _st_getattr(_name):
        # every strategy constructor (integers, sampled_from, composite, ...)
        # returns an inert placeholder; the decorated test never runs.
        return _strategy_stub

    st.__getattr__ = _st_getattr  # type: ignore[attr-defined]  # PEP 562
    hyp.given = given  # type: ignore[attr-defined]
    hyp.settings = settings  # type: ignore[attr-defined]
    hyp.strategies = st  # type: ignore[attr-defined]
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st
