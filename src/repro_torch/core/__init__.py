"""The port's own copy of the reference's analytical core: the Workload
IR with its CNN and LM front-ends and the registry, the FPGA boards and
the H100 spec, the paper's paradigm 1-3 models and two-level DSE, the
one-card counterpart of the TPU model and its DSE, and the measured
accelerator model that prices workloads from a kernel calibration. Pure
Python and numpy, no framework import."""
