"""PyTorch/CUDA port of the SAIL reproduction (``src/repro`` is the JAX
reference).

Laid out module for module like ``repro``: ``core/`` (quantization,
Algorithm-1 typeconv, scheduler), ``kernels/<name>/{kernel,ops,ref}.py``
(hand-written CUDA kernels for Hopper beside their plain PyTorch
versions; sources under ``csrc/``), ``models/``, ``serving/``,
``launch/`` and ``configs/``.  Entry points take ``device=`` (default
``"cuda"``) and raise when that device is missing; they never fall back
to the CPU on their own.
"""
