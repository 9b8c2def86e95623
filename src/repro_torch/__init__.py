"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports
nothing of it (nor of JAX). It mirrors the reference layout
(``configs``, ``kernels``, ``models``, ``serve``, ``launch``) so each
module's counterpart is easy to find. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
