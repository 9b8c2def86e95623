"""The Workload IR: one vocabulary for every workload of the port.

The port's copy of the reference's ``repro.core.workload.ir``:

* :class:`Op` (alias :data:`OpInfo`): one profiled operator: kind,
  FLOPs, weight/activation bytes, sharding-axis hints, and for the CNN
  domain the full spatial geometry as a :class:`ConvLayer`;
* :class:`Workload`: provenance metadata and an ordered tuple of ops,
  with the derived quantities every consumer asks for (``total_ops``,
  ``model_flops``, ``ctc_stats``, per-op intensity);
* :class:`WorkloadError` / :class:`EmptyWorkloadError`: typed errors
  that always name the offending workload.

The front-ends (``cnn``, ``lm``) build Workloads; the analytical models,
the DSE engines and the simulator only read them. Keep the two packages
in step: the parity tests compare them op by op.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


class WorkloadError(ValueError):
    """A workload violates a structural contract (always names it)."""


# ===========================================================================
# Precision vocabulary
# ===========================================================================
#: Bytes per element of every dtype an Op may declare. fp8 aliases map
#: onto the e4m3 storage width; int4 is the only sub-byte entry (packed
#: two to a byte, so byte math stays exact with float arithmetic).
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
    """Bytes per element of a declared dtype name.

    ``None`` means "unspecified — keep whatever byte accounting the
    front-end already did" and returns ``default`` (bf16's 2 bytes, the
    historical hardwired element size every consumer assumed).
    Unknown names raise so a typo'd dtype can't silently halve or
    double a byte budget.
    """
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


# ===========================================================================
# Spatial geometry (FPGA-domain CNN vocabulary, paper section 4.3)
# ===========================================================================
@dataclass(frozen=True)
class ConvLayer:
    """One major pipeline-stage layer: CONV (or FC as 1x1 CONV on 1x1 map).

    h, w: *input* feature map spatial dims; r, s: kernel; stride.
    POOL layers are folded into the preceding CONV stage (paper §4.1:
    BN/activation/pooling concatenate into the major layer).

    This is the ``spatial`` payload of a CNN-domain :class:`Op`: the
    FPGA analytical models (Algorithms 1-3) need the full geometry, not
    just the aggregate FLOPs/bytes the scalar Op fields carry.
    """

    name: str
    h: int
    w: int
    cin: int
    cout: int
    r: int = 3
    s: int = 3
    stride: int = 1
    pad: int = -1          # -1 => 'same' (r//2)
    pool: int = 1          # output downsample by max-pool after the conv

    @property
    def h_out(self) -> int:
        pad = self.r // 2 if self.pad < 0 else self.pad
        return (self.h + 2 * pad - self.r) // self.stride + 1

    @property
    def w_out(self) -> int:
        pad = self.s // 2 if self.pad < 0 else self.pad
        return (self.w + 2 * pad - self.s) // self.stride + 1

    @property
    def h_final(self) -> int:
        return max(1, self.h_out // self.pool)

    @property
    def w_final(self) -> int:
        return max(1, self.w_out // self.pool)

    @property
    def macs(self) -> int:
        return self.h_out * self.w_out * self.r * self.s * self.cin * self.cout

    @property
    def ops(self) -> int:
        return 2 * self.macs

    @property
    def weight_count(self) -> int:
        return self.r * self.s * self.cin * self.cout

    def in_bytes(self, abits: int) -> float:
        return self.h * self.w * self.cin * abits / 8.0

    def out_bytes(self, abits: int) -> float:
        return self.h_final * self.w_final * self.cout * abits / 8.0

    def weight_bytes(self, wbits: int) -> float:
        return self.weight_count * wbits / 8.0

    def ctc(self, abits: int = 16, wbits: int = 16,
            mode: str = "external") -> float:
        """Computation-to-communication ratio (ops per DRAM byte), Fig. 6.

        mode='external' counts DRAM traffic with feature maps resident
        on-chip between layers (the paper's accelerator view: weights are
        the streamed data) — this is what yields the ~256x median growth
        from 32^2 to 512^2 inputs. mode='total' adds fmap in/out bytes.
        """
        comm = self.weight_bytes(wbits)
        if mode == "total":
            comm += self.in_bytes(abits) + self.out_bytes(abits)
        return self.ops / comm


# ===========================================================================
# The unified operator record
# ===========================================================================
#: Valid Op.kind values (informative, not enforced): conv and matmul are
#: weight-bearing GEMM-shaped work; attention covers activation-activation
#: products (attention scores/PV and SSD chunk outer/inner products);
#: scan is recurrent state-update math; router/embed/norm are the small
#: auxiliary ops the one-card model prices as they are.
OP_KINDS = ("conv", "matmul", "attention", "scan", "router", "embed", "norm")

#: Kinds whose FLOPs are dot-product work fed from resident weights.
WEIGHT_FLOP_KINDS = ("conv", "matmul", "router")

#: Kinds whose FLOPs are activation-activation work (no weight operand).
ACTIVATION_FLOP_KINDS = ("attention", "scan")


@dataclass(frozen=True)
class Op:
    """One profiled operator group.

    Field order is load-bearing: it matches the legacy ``OpInfo``
    positional constructor, so ``OpInfo`` is now just an alias.

    flops:        forward FLOPs for the whole global batch/seq slice
    weight_bytes: parameter bytes touched
    act_in/out:   activation bytes in/out
    kind:         one of :data:`OP_KINDS`
    weight_axis:  logical sharding axis of the weight's wide dim (the
                  model-parallel candidate)
    width:        size of that dim (divisibility check)
    spatial:      full conv geometry for CNN-domain ops (the FPGA
                  analytical models read this; None for LM/traced ops)
    weight_dtype: declared storage dtype of the weight operand
                  (:data:`DTYPE_BYTES` key). ``None`` = unspecified:
                  the byte fields above are authoritative as-is and
                  every consumer keeps its historical element-size
                  assumption — adding these fields changes no number.
    act_dtype:    declared dtype of the dominant activation operand
                  (for attention ops: the KV-cache storage dtype).
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
    spatial: Optional[ConvLayer] = None
    weight_dtype: Optional[str] = None
    act_dtype: Optional[str] = None

    @property
    def total_bytes(self) -> float:
        return self.weight_bytes + self.act_in_bytes + self.act_out_bytes

    @property
    def intensity(self) -> float:
        """Arithmetic intensity: FLOPs per byte moved."""
        return self.flops / max(self.total_bytes, 1.0)

    def ctc(self, abits: int = 16, wbits: int = 16,
            mode: str = "external") -> float:
        """Per-op computation-to-communication ratio.

        Spatial (CNN) ops delegate to the exact legacy ConvLayer formula
        so the CNN front-end reproduces the zoo numbers bit-for-bit;
        scalar ops use the stored byte fields.
        """
        if self.spatial is not None:
            return self.spatial.ctc(abits, wbits, mode)
        comm = self.weight_bytes
        if mode == "total":
            comm += self.act_in_bytes + self.act_out_bytes
        return self.flops / max(comm, 1.0)


#: The reference's older name for the same record.
OpInfo = Op


# ===========================================================================
# The workload container
# ===========================================================================
@dataclass(frozen=True)
class Workload:
    """Provenance metadata + ordered :class:`Op` records.

    ``frontend`` names the front-end that built it (``cnn`` / ``lm`` /
    ``adhoc``); ``kind`` is the execution flavour
    (``infer`` for the CNN domain, ``train``/``prefill``/``decode`` for
    the LM domain); ``meta`` carries front-end-specific provenance
    (arch/shape names, input size, token counts, ...).

    ``model_flops_hint`` is the useful-work FLOP count (6ND-style) the
    roofline and one-card efficiency consumers divide by; when zero,
    :meth:`model_flops` falls back to the sum of op FLOPs.
    """

    name: str
    frontend: str
    ops: Tuple[Op, ...]
    kind: str = "infer"
    meta: Dict[str, Any] = field(default_factory=dict)
    model_flops_hint: float = 0.0

    # -- container protocol -------------------------------------------------
    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def _require_ops(self, what: str) -> Tuple[Op, ...]:
        if not self.ops:
            raise EmptyWorkloadError(self.name, what)
        return self.ops

    # -- derived quantities --------------------------------------------------
    def total_ops(self) -> float:
        """Total FLOPs over all ops (legacy ``total_ops`` semantics)."""
        return float(sum(o.flops for o in self._require_ops("total_ops")))

    def model_flops(self) -> float:
        """Useful-work FLOPs (the 6ND roofline numerator)."""
        if self.model_flops_hint > 0:
            return float(self.model_flops_hint)
        return self.total_ops()

    def total_weight_bytes(self) -> float:
        return float(sum(o.weight_bytes
                         for o in self._require_ops("total_weight_bytes")))

    def total_act_bytes(self) -> float:
        return float(sum(o.act_in_bytes + o.act_out_bytes
                         for o in self._require_ops("total_act_bytes")))

    def flops_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self._require_ops("flops_by_kind"):
            out[o.kind] = out.get(o.kind, 0.0) + o.flops
        return out

    def weight_flops(self) -> float:
        """Dot-product FLOPs fed from weights — the diff axis."""
        return float(sum(o.flops
                         for o in self._require_ops("weight_flops")
                         if o.kind in WEIGHT_FLOP_KINDS))

    def intensity(self) -> float:
        ops = self._require_ops("intensity")
        byts = sum(o.total_bytes for o in ops)
        return sum(o.flops for o in ops) / max(byts, 1.0)

    def ctc_stats(self, abits: int = 16, wbits: int = 16,
                  mode: str = "external") -> Dict[str, float]:
        """min/median/max per-op CTC (Fig. 6 vocabulary)."""
        ops = self._require_ops("ctc_stats")
        vals = sorted(o.ctc(abits, wbits, mode) for o in ops)
        n = len(vals)
        med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1]
                                                + vals[n // 2])
        return {"min": vals[0], "median": med, "max": vals[-1]}

    # -- domain views ---------------------------------------------------------
    def conv_layers(self) -> List[ConvLayer]:
        """The CNN-domain geometry view the FPGA models consume.

        Raises :class:`WorkloadError` (naming the workload) when any op
        lacks spatial geometry — an LM/traced workload cannot be fed to
        a layer-pipeline allocator.
        """
        ops = self._require_ops("conv_layers")
        missing = [o.name for o in ops if o.spatial is None]
        if missing:
            raise WorkloadError(
                f"workload {self.name!r} (frontend={self.frontend}) has "
                f"{len(missing)} op(s) without conv geometry "
                f"(e.g. {missing[:3]}); only CNN-frontend workloads can "
                f"drive the FPGA layer models")
        return [o.spatial for o in ops]

    # -- coercion --------------------------------------------------------------
    @classmethod
    def coerce(cls, obj: Any, name: str = "adhoc") -> "Workload":
        """Accept a Workload, a ConvLayer sequence, or an Op sequence.

        This is the transitional shim that lets the analytical models
        take either the new IR or the legacy lists the existing tests
        construct by hand.
        """
        if isinstance(obj, Workload):
            return obj
        try:
            seq = list(obj)
        except TypeError:
            raise WorkloadError(
                f"cannot coerce {type(obj).__name__} into workload "
                f"{name!r}: expected Workload, Sequence[ConvLayer] or "
                f"Sequence[Op]") from None
        if seq and isinstance(seq[0], ConvLayer):
            from repro_torch.core.workload.cnn import (
                workload_from_conv_layers,
            )
            return workload_from_conv_layers(seq, name=name)
        if all(isinstance(o, Op) for o in seq):
            return cls(name=name, frontend="adhoc", ops=tuple(seq))
        raise WorkloadError(
            f"cannot coerce {type(obj).__name__} into workload {name!r}: "
            f"expected Workload, Sequence[ConvLayer] or Sequence[Op]")

    # -- reporting -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        by_kind = {k: round(v, 1) for k, v in self.flops_by_kind().items()}
        return {
            "name": self.name,
            "frontend": self.frontend,
            "kind": self.kind,
            "ops": len(self.ops),
            "total_gflop": self.total_ops() / 1e9,
            "model_gflop": self.model_flops() / 1e9,
            "weight_gb": self.total_weight_bytes() / 1e9,
            "act_gb": self.total_act_bytes() / 1e9,
            "flops_by_kind": by_kind,
        }

    def describe(self) -> str:
        s = self.summary()
        return (f"{s['name']} [{s['frontend']}/{s['kind']}] "
                f"{s['ops']} ops, {s['total_gflop']:.2f} GFLOP, "
                f"{s['weight_gb']:.3f} GB weights")


# ===========================================================================
# Legacy helper functions (coerce either vocabulary)
# ===========================================================================
def as_conv_layers(obj: Any, name: str = "adhoc") -> List[ConvLayer]:
    """Geometry view of a Workload / ConvLayer sequence.

    The hot-path variant of ``Workload.coerce(obj).conv_layers()``: the
    FPGA level-2 allocators run inside the DSE fitness function hundreds
    of times per search, so a bare ConvLayer sequence must not pay for
    building Op records on every call.
    """
    if isinstance(obj, Workload):
        return obj.conv_layers()
    seq = list(obj)
    if all(isinstance(l, ConvLayer) for l in seq):
        return seq
    return Workload.coerce(seq, name=name).conv_layers()

