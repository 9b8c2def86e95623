"""The paper's figures from the port: Fig. 4-6 and 8-11 on the port's
FPGA models, paradigms 1-3, the two-level DSE and the event simulator
(``repro_torch.core``, ``repro_torch.sim``). Each module is the port's
copy of the reference's ``benchmarks/<fig>.py``; the runner is

    PYTHONPATH=src python -m repro_torch.bench.figures [--quick] \\
        [--only fig6,fig11] [--list]

and writes ``results.json`` (and each figure's rows) under
``repro_torch.artifacts.bench_dir()``.
"""
