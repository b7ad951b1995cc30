"""Replica-side LLM serving, ported from ``ray_tpu.serve.llm``."""

from ray_tpu_torch.serve.llm import LLMEngine, LLMServer  # noqa: F401
