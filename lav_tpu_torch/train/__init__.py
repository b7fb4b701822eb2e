"""Training steps of the port (counterpart of `lav_tpu/train/`)."""

from lav_tpu_torch.train.distill import make_full_train_step
from lav_tpu_torch.train.privileged import (
    make_bev_train_step, make_bra_train_step, make_seg_train_step,
)

__all__ = ["make_bev_train_step", "make_bra_train_step",
           "make_full_train_step", "make_seg_train_step"]
