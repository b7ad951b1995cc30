"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu's model path.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports). Its modules mirror the JAX package's layout and names:
``ops/attention.py``, ``ops/flash_attention.py`` (hand-written CUDA C++
flash-attention forward and backward kernels for Hopper),
``ops/int8_matmul.py`` (a hand-written int8 weight-only matmul kernel),
``models/transformer.py``, ``models/generation.py``, ``models/convert.py``,
``models/quant.py`` (int8 weights for serving), ``parallel/train_step.py``
and ``serve/llm.py``.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
