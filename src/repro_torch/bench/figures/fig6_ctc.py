"""Fig. 6 reproduction: CTC (computation-to-communication) distribution
of VGG-16 CONV layers across 12 input resolutions.

Paper: CTC medians rise ~256x from 32x32 to 512x512 inputs.

``Workload.ctc_stats`` (the IR's per-op CTC) replaces the old
free-standing helper over ConvLayer lists.

The port's copy of ``benchmarks/fig6_ctc.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.workload import INPUT_SIZE_CASES, get_workload

from repro_torch.bench.figures.common import emit


def run():
    rows = []
    for sz in INPUT_SIZE_CASES:
        stats = get_workload("vgg16", input_size=sz).ctc_stats()
        rows.append({"input": sz, **stats})
    growth = rows[-1]["median"] / rows[0]["median"]
    emit("fig6_ctc", rows)
    print(f"[fig6] CTC median growth 32->512: {growth:.1f}x "
          f"(paper: ~256x)")
    return {"median_growth": growth, "paper_growth": 256.0,
            "pass": 128.0 <= growth <= 512.0}


if __name__ == "__main__":
    run()
