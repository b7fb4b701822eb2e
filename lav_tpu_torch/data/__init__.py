"""Episode stores, datasets and the loader (counterpart of `lav_tpu/data/`)."""

from lav_tpu_torch.data.store import (  # noqa: F401
    DictStore,
    Episode,
    open_episode,
    make_synthetic_episode,
)
from lav_tpu_torch.data.datasets import get_dataset  # noqa: F401
from lav_tpu_torch.data.loader import DataLoader  # noqa: F401
