"""PyTorch + CUDA port of the ClusterFusion serving system.

A second package beside the JAX reference (``repro``): same module
layout, same public tensor layouts, PyTorch idiom inside.  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro`` —
and every decode step runs through hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` at first use, see ``kernels/_build.py``).

Entry points default to ``device="cuda"``; the CPU runs only when the
caller passes ``device="cpu"`` (the tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""
