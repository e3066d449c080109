"""PyTorch/CUDA port of elasticsearch_tpu.

A package of its own beside the JAX package, which stays the reference:
it imports ``torch``, never ``jax``, and nothing of ``elasticsearch_tpu``.
Module names mirror the reference's, so each module's counterpart is
found under the same path. The hand-written Hopper kernels live in
``csrc/`` and build at first use (``ops/_build.py``).
"""
