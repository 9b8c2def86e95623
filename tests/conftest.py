"""Shared test fixtures and a ``hypothesis`` fallback shim.

Several modules use hypothesis property tests. When the package is not
installed (bare CPU CI image), importing those modules at collection
time used to kill the whole suite. Here we install a minimal stub into
``sys.modules`` *before* any test module imports it: ``@given`` turns
the test into a pytest-skip, strategy constructors accept anything, and
``@settings`` is a no-op. With real hypothesis installed
(``pip install -r requirements-dev.txt``) the shim is inert.
"""
from __future__ import annotations

import sys
import types

import pytest

try:
    import hypothesis  # noqa: F401  (real package wins)
except ImportError:
    _SKIP = pytest.mark.skip(
        reason="hypothesis not installed (see requirements-dev.txt); "
               "property test skipped")

    class _Strategy:
        """Inert stand-in for hypothesis strategy objects."""

        def __init__(self, *a, **k):
            pass

        def __call__(self, *a, **k):
            return self

        def map(self, *a, **k):
            return self

        def filter(self, *a, **k):
            return self

        def flatmap(self, *a, **k):
            return self

    def _strategy_factory(*_a, **_k):
        return _Strategy()

    def _given(*_a, **_k):
        def deco(fn):
            return _SKIP(fn)
        return deco

    def _settings(*_a, **_k):
        # usable both as @settings(...) decorator and settings(...) call
        def deco(fn):
            return fn
        return deco

    def _assume(_cond=True):
        return True

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "booleans", "text", "lists",
                  "tuples", "sampled_from", "one_of", "just", "none",
                  "dictionaries", "composite", "builds", "binary",
                  "characters", "sets", "permutations", "data"):
        setattr(_st, _name, _strategy_factory)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = _assume
    _hyp.note = lambda *_a, **_k: None
    _hyp.example = lambda *_a, **_k: (lambda fn: fn)
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(
        too_slow=None, data_too_large=None, filter_too_much=None)

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel on an NVIDIA GPU; skips "
        "with a reason on a host without one")
