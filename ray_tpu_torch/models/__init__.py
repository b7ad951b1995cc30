"""The flagship decoder-only LM, ported from ``ray_tpu.models``."""

from ray_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    param_logical_axes,
)
