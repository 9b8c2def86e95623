"""The port's own copy of the reference's analytical core: the Workload
IR with its LM front-end, the H100 spec, and the measured accelerator
model that prices workloads from a kernel calibration. Pure Python, no
framework import."""
