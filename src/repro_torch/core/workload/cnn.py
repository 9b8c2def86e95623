"""CNN front-end: the FPGA-domain layer zoo lowered into the Workload IR.

The zoo functions (AlexNet/ZF/VGG16/YOLO/ResNet from public configs)
still build :class:`ConvLayer` chains — that geometry is what
Algorithms 1-3 consume — but the public product is now a
:class:`~repro_torch.core.workload.ir.Workload` whose ops carry both the
unified scalar fields and the spatial payload. Totals and CTC stats are
byte-for-byte identical to the legacy ``List[ConvLayer]`` path. The
port's copy of the reference's ``repro.core.workload.frontends.cnn``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.workload.ir import (ConvLayer, DTYPE_BYTES, Op,
                                          Workload, WorkloadError)


# ---------------------------------------------------------------------------
# Zoo builders (geometry level)
# ---------------------------------------------------------------------------
def _chain(cfgs, h, w, name_prefix="conv") -> List[ConvLayer]:
    """cfgs: list of (cout, r, stride, pool) applied sequentially."""
    layers = []
    cin = 3
    for i, (cout, r, stride, pool) in enumerate(cfgs):
        layer = ConvLayer(
            f"{name_prefix}{i + 1}", h=h, w=w, cin=cin, cout=cout,
            r=r, s=r, stride=stride, pool=pool,
        )
        layers.append(layer)
        h, w, cin = layer.h_final, layer.w_final, cout
        h = max(h, 1)
        w = max(w, 1)
    return layers


def vgg16_conv(input_size: int = 224, extra_per_group: int = 0) -> List[ConvLayer]:
    """VGG-16 CONV trunk (no FC), optionally deepened per paper §6.3.

    extra_per_group = 0/1/3/5 gives the 13/18/28/38-layer VGG-like DNNs.
    """
    groups = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    cfgs = []
    for cout, n in groups:
        n = n + extra_per_group
        for j in range(n):
            pool = 2 if j == n - 1 else 1
            cfgs.append((cout, 3, 1, pool))
    return _chain(cfgs, input_size, input_size, "conv")


def alexnet(input_size: int = 224) -> List[ConvLayer]:
    """torchvision AlexNet: 5 CONV (+pools) + 3 FC."""
    layers = []
    l1 = ConvLayer("conv1", input_size, input_size, 3, 64, 11, 11, stride=4, pad=2, pool=2)
    layers.append(l1)
    l2 = ConvLayer("conv2", l1.h_final, l1.w_final, 64, 192, 5, 5, pad=2, pool=2)
    layers.append(l2)
    l3 = ConvLayer("conv3", l2.h_final, l2.w_final, 192, 384, 3, 3)
    layers.append(l3)
    l4 = ConvLayer("conv4", l3.h_final, l3.w_final, 384, 256, 3, 3)
    layers.append(l4)
    l5 = ConvLayer("conv5", l4.h_final, l4.w_final, 256, 256, 3, 3, pool=2)
    layers.append(l5)
    flat = l5.h_final * l5.w_final * 256
    layers.append(ConvLayer("fc1", 1, 1, flat, 4096, 1, 1, pad=0))
    layers.append(ConvLayer("fc2", 1, 1, 4096, 4096, 1, 1, pad=0))
    layers.append(ConvLayer("fc3", 1, 1, 4096, 1000, 1, 1, pad=0))
    return layers


def zfnet(input_size: int = 224) -> List[ConvLayer]:
    layers = []
    l1 = ConvLayer("conv1", input_size, input_size, 3, 96, 7, 7, stride=2, pad=1, pool=2)
    layers.append(l1)
    l2 = ConvLayer("conv2", l1.h_final, l1.w_final, 96, 256, 5, 5, stride=2, pad=0, pool=2)
    layers.append(l2)
    l3 = ConvLayer("conv3", l2.h_final, l2.w_final, 256, 384, 3, 3)
    layers.append(l3)
    l4 = ConvLayer("conv4", l3.h_final, l3.w_final, 384, 384, 3, 3)
    layers.append(l4)
    l5 = ConvLayer("conv5", l4.h_final, l4.w_final, 384, 256, 3, 3, pool=2)
    layers.append(l5)
    flat = l5.h_final * l5.w_final * 256
    layers.append(ConvLayer("fc1", 1, 1, flat, 4096, 1, 1, pad=0))
    layers.append(ConvLayer("fc2", 1, 1, 4096, 4096, 1, 1, pad=0))
    layers.append(ConvLayer("fc3", 1, 1, 4096, 1000, 1, 1, pad=0))
    return layers


def yolo_tiny(input_size: int = 448) -> List[ConvLayer]:
    """Tiny-YOLOv1 trunk (9 CONV), the DNNBuilder YOLO benchmark shape."""
    cfgs = [
        (16, 3, 1, 2), (32, 3, 1, 2), (64, 3, 1, 2), (128, 3, 1, 2),
        (256, 3, 1, 2), (512, 3, 1, 2), (1024, 3, 1, 1), (1024, 3, 1, 1),
        (1024, 3, 1, 1),
    ]
    return _chain(cfgs, input_size, input_size, "conv")


def _resnet_blocks(layers_per_stage: Sequence[int], input_size: int) -> List[ConvLayer]:
    out: List[ConvLayer] = []
    stem = ConvLayer("conv1", input_size, input_size, 3, 64, 7, 7, stride=2, pad=3, pool=2)
    out.append(stem)
    h = w = stem.h_final
    cin = 64
    widths = [64, 128, 256, 512]
    for stage, (n_blocks, cout) in enumerate(zip(layers_per_stage, widths)):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            l1 = ConvLayer(f"s{stage}b{b}c1", h, w, cin, cout, 3, 3, stride=stride)
            out.append(l1)
            h, w = l1.h_final, l1.w_final
            l2 = ConvLayer(f"s{stage}b{b}c2", h, w, cout, cout, 3, 3)
            out.append(l2)
            if stride == 2 or cin != cout:
                out.append(ConvLayer(f"s{stage}b{b}ds", l1.h, l1.w, cin, cout, 1, 1,
                                     stride=stride, pad=0))
            cin = cout
    out.append(ConvLayer("fc", 1, 1, 512, 1000, 1, 1, pad=0))
    return out


def resnet18(input_size: int = 224) -> List[ConvLayer]:
    return _resnet_blocks([2, 2, 2, 2], input_size)


def resnet34(input_size: int = 224) -> List[ConvLayer]:
    return _resnet_blocks([3, 4, 6, 3], input_size)


CNN_ZOO = {
    "vgg16": vgg16_conv,
    "alexnet": alexnet,
    "zf": zfnet,
    "yolo": yolo_tiny,
    "resnet18": resnet18,
    "resnet34": resnet34,
}

#: Default input resolution per zoo entry (the paper's benchmark shapes).
ZOO_DEFAULT_INPUT = {
    "vgg16": 224, "alexnet": 224, "zf": 224,
    "yolo": 448, "resnet18": 224, "resnet34": 224,
}

# Fig. 6 / Fig. 8 input-size sweep (12 cases).
INPUT_SIZE_CASES = [32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512]


# ---------------------------------------------------------------------------
# IR lowering
# ---------------------------------------------------------------------------
def _bits_dtype(bits: int) -> Optional[str]:
    """intN name for a bit width when the IR knows it, else None."""
    name = f"int{bits}"
    return name if name in DTYPE_BYTES else None


def conv_layer_op(layer: ConvLayer, idx: int,
                  abits: int = 16, wbits: int = 16) -> Op:
    """One ConvLayer as a unified Op record (keeps the geometry)."""
    is_fc = layer.r == 1 and layer.s == 1 and layer.h == 1 and layer.w == 1
    return Op(
        name=layer.name,
        kind="matmul" if is_fc else "conv",
        flops=float(layer.ops),
        weight_bytes=layer.weight_bytes(wbits),
        act_in_bytes=layer.in_bytes(abits),
        act_out_bytes=layer.out_bytes(abits),
        layer_idx=idx,
        weight_axis="cout",
        width=layer.cout,
        spatial=layer,
        weight_dtype=_bits_dtype(wbits),
        act_dtype=_bits_dtype(abits),
    )


def workload_from_conv_layers(layers: Sequence[ConvLayer], name: str,
                              abits: int = 16, wbits: int = 16,
                              **meta) -> Workload:
    """Wrap an existing ConvLayer chain (zoo output, hand-built tests)."""
    ops = tuple(conv_layer_op(l, i, abits, wbits)
                for i, l in enumerate(layers))
    return Workload(name=name, frontend="cnn", ops=ops, kind="infer",
                    meta={"abits": abits, "wbits": wbits, **meta})


def cnn_workload(net: str, input_size: Optional[int] = None,
                 extra_per_group: int = 0,
                 abits: int = 16, wbits: int = 16) -> Workload:
    """Zoo entry -> Workload (the CNN front-end proper)."""
    if net not in CNN_ZOO:
        raise WorkloadError(
            f"unknown CNN workload {net!r}; available: {sorted(CNN_ZOO)}")
    size = input_size if input_size is not None else ZOO_DEFAULT_INPUT[net]
    if net == "vgg16":
        layers = vgg16_conv(size, extra_per_group=extra_per_group)
    else:
        if extra_per_group:
            raise WorkloadError(
                f"extra_per_group only applies to vgg16, not {net!r}")
        layers = CNN_ZOO[net](size)
    name = f"{net}@{size}"
    if extra_per_group:
        name += f"+{extra_per_group}pg"
    return workload_from_conv_layers(
        layers, name, abits, wbits,
        net=net, input_size=size, extra_per_group=extra_per_group)


def conv_case_workload(fmap: int, cin: int, cout: Optional[int] = None,
                       k: int = 3, stride: int = 1,
                       abits: int = 16, wbits: int = 16) -> Workload:
    """Single synthetic CONV case (the Fig. 5 sweep vocabulary)."""
    cout = cin if cout is None else cout
    layer = ConvLayer(f"c{fmap}_{cin}_{k}", fmap, fmap, cin, cout, k, k,
                      stride=stride)
    return workload_from_conv_layers(
        [layer], f"conv{fmap}x{fmap}c{cin}k{k}", abits, wbits,
        fmap=fmap, cin=cin, cout=cout, k=k)
