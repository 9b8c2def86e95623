"""The Workload IR and its front-ends (the port's copy of
``repro.core.workload``): the IR, the CNN zoo, the analytic LM profile,
the trace front-end (the port's own model traced into the IR, the
counterpart of the reference's JAX trace) and the registry behind
``python -m repro_torch.workloads``."""
from repro_torch.core.workload.ir import (
    ACTIVATION_FLOP_KINDS,
    DTYPE_BYTES,
    OP_KINDS,
    WEIGHT_FLOP_KINDS,
    ConvLayer,
    EmptyWorkloadError,
    Op,
    OpInfo,
    Workload,
    WorkloadError,
    as_conv_layers,
    dtype_bytes,
)
from repro_torch.core.workload.cnn import (
    CNN_ZOO,
    INPUT_SIZE_CASES,
    ZOO_DEFAULT_INPUT,
    alexnet,
    cnn_workload,
    conv_case_workload,
    resnet18,
    resnet34,
    vgg16_conv,
    workload_from_conv_layers,
    yolo_tiny,
    zfnet,
)
from repro_torch.core.workload.lm import (
    lm_block_ops,
    lm_workload,
    model_flops,
    profile_arch,
)
from repro_torch.core.workload.torch_trace import (
    diff_workloads,
    trace_workload,
)
from repro_torch.core.workload.registry import (
    get_workload,
    list_workloads,
    register_workload,
    resolve_arch,
    resolve_shape,
)

__all__ = [
    # IR
    "Op", "OpInfo", "Workload", "ConvLayer",
    "WorkloadError", "EmptyWorkloadError",
    "OP_KINDS", "WEIGHT_FLOP_KINDS", "ACTIVATION_FLOP_KINDS",
    "DTYPE_BYTES", "dtype_bytes",
    "as_conv_layers",
    # CNN front-end
    "CNN_ZOO", "ZOO_DEFAULT_INPUT", "INPUT_SIZE_CASES",
    "vgg16_conv", "alexnet", "zfnet", "yolo_tiny", "resnet18", "resnet34",
    "cnn_workload", "conv_case_workload", "workload_from_conv_layers",
    # LM front-end
    "lm_block_ops", "profile_arch", "model_flops", "lm_workload",
    # trace front-end
    "trace_workload", "diff_workloads",
    # registry
    "get_workload", "list_workloads", "register_workload",
    "resolve_arch", "resolve_shape",
]
