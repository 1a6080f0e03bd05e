"""LM training on the PyTorch port: AdamW (``optimizer``), the train step
with microbatches and int8 gradient compression (``train_step``) and the
fault-tolerant ``Trainer`` (``trainer``)."""

from repro_torch.train.optimizer import OptConfig, lr_at, opt_abstract, opt_update
from repro_torch.train.train_step import make_train_step

__all__ = ["OptConfig", "opt_abstract", "opt_update", "lr_at", "make_train_step"]
