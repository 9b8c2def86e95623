"""User-facing workload surface: ``python -m repro_torch.workloads ...``.

The port's copy of the reference's ``repro.workloads``: a thin re-export
of the Workload IR, the front-ends and the registry
(:mod:`repro_torch.core.workload`) plus the CLI in :mod:`__main__`:

* ``list``: every registered workload and the parametric families;
* ``show <spec>``: per-op table and totals for one workload;
* ``diff``: the traced-vs-analytic cross-check.
"""
from repro_torch.core.workload import (  # noqa: F401
    ConvLayer,
    EmptyWorkloadError,
    Op,
    OpInfo,
    Workload,
    WorkloadError,
    cnn_workload,
    conv_case_workload,
    diff_workloads,
    get_workload,
    list_workloads,
    lm_workload,
    register_workload,
    resolve_arch,
    resolve_shape,
    trace_workload,
)
