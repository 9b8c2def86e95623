"""Workload registry: names -> front-end builders.

Three spec forms resolve through :func:`get_workload`:

* a CNN zoo id — ``"vgg16"``, ``"alexnet"``, ... (kwargs:
  ``input_size``, ``extra_per_group``) and ``"conv_case"`` (the Fig. 5
  single-layer sweep vocabulary);
* ``"<arch>/<shape>"`` — the analytic LM front-end, e.g.
  ``"minicpm-2b/train_4k"`` (arch ids are normalized, so the
  underscore spelling ``minicpm_2b`` works too);
* ``"trace:<arch>/<shape>"`` — the trace front-end on the same cell (a
  trace of the port's own model, ``torch_trace``).

The port's copy of the reference's ``repro.core.workload.registry``,
over the port's ``ARCHS``/``SHAPES``. New front-ends register with :func:`register_workload` (a name + a
builder returning a :class:`Workload`) and immediately show up in the
``python -m repro_torch.workloads`` CLI.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List

from repro_torch.core.workload.ir import Workload, WorkloadError
from repro_torch.core.workload.cnn import (
    CNN_ZOO,
    ZOO_DEFAULT_INPUT,
    cnn_workload,
    conv_case_workload,
)
from repro_torch.core.workload.lm import lm_workload

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_workload(name: str, builder: Callable[..., Workload],
                      description: str, frontend: str = "custom") -> None:
    """Register a named workload builder (``builder(**kwargs)``)."""
    _REGISTRY[name] = {"builder": builder, "description": description,
                       "frontend": frontend}


def _canon(s: str) -> str:
    return re.sub(r"[-_.]", "", s.lower())


def _resolve(name: str, table, what: str) -> str:
    """Resolve an id tolerant of -/_/. spelling differences."""
    if name in table:
        return name
    wanted = _canon(name)
    for k in table:
        if _canon(k) == wanted:
            return k
    raise WorkloadError(
        f"unknown {what} {name!r}; available: {sorted(table)}")


def resolve_arch(name: str) -> str:
    from repro_torch.configs import ARCHS
    return _resolve(name, ARCHS, "architecture")


def resolve_shape(name: str) -> str:
    from repro_torch.configs import SHAPES
    return _resolve(name, SHAPES, "shape")


def get_workload(spec: str, **kwargs) -> Workload:
    """Resolve a workload spec (see module docstring) to a Workload."""
    if spec in _REGISTRY:
        return _REGISTRY[spec]["builder"](**kwargs)
    if spec.startswith("trace:"):
        from repro_torch.core.workload.torch_trace import trace_workload
        body = spec[len("trace:"):]
        if "/" not in body:
            raise WorkloadError(
                f"trace spec must be 'trace:<arch>/<shape>', got {spec!r}")
        arch, shape = body.split("/", 1)
        return trace_workload(resolve_arch(arch), resolve_shape(shape),
                              **kwargs)
    if "/" in spec:
        arch, shape = spec.split("/", 1)
        return lm_workload(resolve_arch(arch), resolve_shape(shape),
                           **kwargs)
    raise WorkloadError(
        f"unknown workload {spec!r}; use one of {sorted(_REGISTRY)}, "
        f"'<arch>/<shape>', or 'trace:<arch>/<shape>' "
        f"(see `python -m repro_torch.workloads list`)")


def list_workloads() -> List[Dict[str, str]]:
    """Rows for the CLI: every registered name + the parametric families."""
    from repro_torch.configs import ARCHS, SHAPES
    rows = [
        {"name": name, "frontend": e["frontend"],
         "description": e["description"]}
        for name, e in sorted(_REGISTRY.items())
    ]
    for arch in sorted(ARCHS):
        for shape in sorted(SHAPES):
            rows.append({"name": f"{arch}/{shape}", "frontend": "lm",
                         "description": "analytic LM profile"})
            rows.append({"name": f"trace:{arch}/{shape}",
                         "frontend": "torch_trace",
                         "description": "torch trace of the port's model"})
    return rows


# ---------------------------------------------------------------------------
# Built-in registrations
# ---------------------------------------------------------------------------
for _net in CNN_ZOO:
    register_workload(
        _net,
        (lambda _n: lambda **kw: cnn_workload(_n, **kw))(_net),
        f"CNN zoo entry (default input {ZOO_DEFAULT_INPUT[_net]}; "
        f"kwargs: input_size"
        + (", extra_per_group" if _net == "vgg16" else "") + ")",
        frontend="cnn",
    )
register_workload(
    "conv_case", lambda **kw: conv_case_workload(**kw),
    "single synthetic CONV layer (kwargs: fmap, cin, k, [cout, stride])",
    frontend="cnn",
)
