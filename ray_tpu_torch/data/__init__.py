"""ray_tpu_torch.data — the Data-equivalent library (PyTorch port of
``ray_tpu.data``).

Block-based lazy datasets executed by a streaming, backpressured executor
over the task/object plane (parity: reference ``python/ray/data/``; see
dataset.py / streaming.py for the component mapping). Typical card use:

    import ray_tpu_torch.data as rd
    ds = rd.read_numpy("/data/tokens").map_batches(preprocess)
    # a TorchTrainer(datasets={"train": ds}) worker:
    it = session.get_dataset_shard("train")
    for batch in it.iter_device_batches(batch_size=8): ...

``import ray_tpu_torch.data`` loads no torch: only the device pump
(``device_batches``, ``DataIterator.iter_device_batches``) needs it, and
imports it when called, so CPU data tasks start without torch.
"""

from ray_tpu_torch.data.dataset import (  # noqa: F401
    Dataset,
    GroupedData,
    from_items,
    range,  # noqa: A004 — parity with ray.data.range
)
from ray_tpu_torch.data.io import (  # noqa: F401
    from_arrow,
    from_huggingface,
    from_numpy,
    from_pandas,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
)
from ray_tpu_torch.data.webdataset import (  # noqa: F401
    read_webdataset,
    write_webdataset,
)
from ray_tpu_torch.data.block import BlockAccessor  # noqa: F401
from ray_tpu_torch.data.iterator import (  # noqa: F401
    DataIterator,
    DeviceBatches,
    device_batches,
)
from ray_tpu_torch.data.streaming import ActorPoolStrategy  # noqa: F401

__all__ = [
    "ActorPoolStrategy",
    "BlockAccessor",
    "Dataset",
    "DataIterator",
    "DeviceBatches",
    "device_batches",
    "GroupedData",
    "from_items",
    "from_arrow",
    "from_numpy",
    "from_pandas",
    "range",
    "read_csv",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
    "write_webdataset",
    "read_binary_files",
    "from_huggingface",
]
