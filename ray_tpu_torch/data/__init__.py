"""Data loading onto the card, ported from ``ray_tpu.data`` (the device
batch pump)."""

from ray_tpu_torch.data.iterator import DeviceBatches, device_batches  # noqa: F401
