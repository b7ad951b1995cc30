"""Hot compute ops: dense attention, the CUDA flash-attention kernels
(``ray_tpu_torch.ops.flash_attention``), the CUDA int8 weight-only matmul
kernel (``ray_tpu_torch.ops.int8_matmul``) and the CUDA decode attention
kernel (``ray_tpu_torch.ops.decode_attention``)."""

from ray_tpu_torch.ops.attention import causal_attention  # noqa: F401
