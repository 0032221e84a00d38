"""PyTorch + CUDA port of the image-captioning framework.

The JAX package ``myimagecaptioningmodel_tpu`` is the reference this port is
checked against. Module names mirror it one for one, so each port module
sits at the path of its counterpart. This package imports ``torch`` and
numpy, never ``jax``, ``flax`` or ``optax``; from the JAX package it reuses
only the modules that import none of them (``config``,
``evaluation.metrics``, ``data.tokenizer``, and ``data.image`` lazily where
image bytes are decoded).

What runs here: greedy caption serving of the adaptive-attention LSTM
family (``inference.server``, ``inference.infer``), with the decode step and
the tied-vocab argmax as hand-written CUDA kernels (``csrc/``) on a CUDA
device, and their plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
