"""Hot compute ops: dense attention and the CUDA flash-attention kernel
(``ray_tpu_torch.ops.flash_attention``)."""

from ray_tpu_torch.ops.attention import causal_attention  # noqa: F401
