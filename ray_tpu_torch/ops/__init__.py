"""Hot compute ops: dense attention, the CUDA flash-attention kernels
(``ray_tpu_torch.ops.flash_attention``) and the CUDA int8 weight-only
matmul kernel (``ray_tpu_torch.ops.int8_matmul``)."""

from ray_tpu_torch.ops.attention import causal_attention  # noqa: F401
