"""The Workload IR: profiled operators and the workload that holds them.

The port's copy of the reference's ``repro.core.workload.ir``, holding
what the LM front-end and the measured model use: :class:`Op` (alias
:data:`OpInfo`), :class:`Workload`, the dtype byte table and the op-kind
vocabulary. The conv geometry of the CNN domain (``ConvLayer``, an
``Op``'s ``spatial`` field) stays behind: no workload of the port has
a convolution. Keep the two in step: the parity tests compare the
port's LM workloads with the reference's op by op.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple


class WorkloadError(ValueError):
    """A workload violates a structural contract (always names it)."""


#: Bytes per element of every dtype an Op may declare (int4 packs two to
#: a byte).
DTYPE_BYTES: Dict[str, float] = {
    "float64": 8.0,
    "float32": 4.0,
    "bfloat16": 2.0,
    "float16": 2.0,
    "int32": 4.0,
    "int16": 2.0,
    "int8": 1.0,
    "uint8": 1.0,
    "fp8": 1.0,
    "float8_e4m3fn": 1.0,
    "float8_e5m2": 1.0,
    "int4": 0.5,
}


def dtype_bytes(dtype: Optional[str], default: float = 2.0) -> float:
    """Bytes per element of a declared dtype name; ``None`` returns
    ``default``. Unknown names raise, so a typo cannot halve or double a
    byte budget."""
    if dtype is None:
        return default
    try:
        return DTYPE_BYTES[dtype]
    except KeyError:
        raise WorkloadError(
            f"unknown dtype {dtype!r}; known: {sorted(DTYPE_BYTES)}"
        ) from None


class EmptyWorkloadError(WorkloadError):
    """A derived quantity was requested from a workload with no ops."""

    def __init__(self, workload_name: str, what: str = "statistics"):
        super().__init__(
            f"workload {workload_name!r} has no ops — cannot compute "
            f"{what}; check the front-end that built it")
        self.workload_name = workload_name


#: Op.kind values: matmul (and conv) are weight-bearing GEMM work;
#: attention covers activation-activation products; scan is recurrent
#: state-update math; router/embed/norm are the small auxiliary ops.
OP_KINDS = ("conv", "matmul", "attention", "scan", "router", "embed", "norm")

#: Kinds whose FLOPs are dot-product work fed from resident weights.
WEIGHT_FLOP_KINDS = ("conv", "matmul", "router")

#: Kinds whose FLOPs are activation-activation work (no weight operand).
ACTIVATION_FLOP_KINDS = ("attention", "scan")


@dataclass(frozen=True)
class Op:
    """One profiled operator group.

    flops:        forward FLOPs for the whole global batch/seq slice
    weight_bytes: parameter bytes touched
    act_in/out:   activation bytes in/out
    kind:         one of :data:`OP_KINDS`
    weight_axis:  logical sharding axis of the weight's wide dim
    width:        size of that dim
    weight_dtype: declared storage dtype of the weight operand (``None``:
                  the byte fields are authoritative as they are)
    act_dtype:    declared dtype of the dominant activation operand (for
                  attention ops: the KV-cache storage dtype)
    """

    name: str
    kind: str
    flops: float
    weight_bytes: float
    act_in_bytes: float
    act_out_bytes: float
    layer_idx: int = -1
    weight_axis: Optional[str] = None
    width: int = 0
    weight_dtype: Optional[str] = None
    act_dtype: Optional[str] = None

    @property
    def total_bytes(self) -> float:
        return self.weight_bytes + self.act_in_bytes + self.act_out_bytes

    @property
    def intensity(self) -> float:
        """Arithmetic intensity: FLOPs per byte moved."""
        return self.flops / max(self.total_bytes, 1.0)


#: The reference's name for the same record.
OpInfo = Op


@dataclass(frozen=True)
class Workload:
    """Provenance metadata and ordered :class:`Op` records.

    ``kind`` is ``train``/``prefill``/``decode`` for the LM domain;
    ``model_flops_hint`` is the useful-work FLOP count (6ND-style); when
    zero, :meth:`model_flops` falls back to the sum of op FLOPs.
    """

    name: str
    frontend: str
    ops: Tuple[Op, ...]
    kind: str = "infer"
    meta: Dict[str, Any] = field(default_factory=dict)
    model_flops_hint: float = 0.0

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def total_ops(self) -> float:
        """Total FLOPs over all ops."""
        if not self.ops:
            raise EmptyWorkloadError(self.name, "total_ops")
        return float(sum(o.flops for o in self.ops))

    def model_flops(self) -> float:
        """Useful-work FLOPs (the 6ND roofline numerator)."""
        if self.model_flops_hint > 0:
            return float(self.model_flops_hint)
        return self.total_ops()

    @classmethod
    def coerce(cls, obj: Any, name: str = "adhoc") -> "Workload":
        """Accept a Workload or a sequence of Ops."""
        if isinstance(obj, Workload):
            return obj
        try:
            seq = list(obj)
        except TypeError:
            seq = None
        if seq is None or not all(isinstance(o, Op) for o in seq):
            raise WorkloadError(
                f"cannot coerce {type(obj).__name__} into workload "
                f"{name!r}: expected Workload or Sequence[Op]")
        return cls(name=name, frontend="adhoc", ops=tuple(seq))
