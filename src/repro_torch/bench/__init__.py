"""The port's benchmarks: their results go under the port's artifact
root (``repro_torch.artifacts.bench_dir``)."""
