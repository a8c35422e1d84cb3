"""Optimizers, the learning-rate schedule and int8 gradient compression.

Port of the JAX package's ``optim/``. ``get_optimizer(train_cfg)`` is
the training policy's optimizer over the reference's parameter leaves
(``models.model.ref_leaves``)."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.grad_compress import (CompressionState,
                                             compressed_psum,
                                             compressed_psum_tree,
                                             init_compression)
from repro_torch.optim.schedule import warmup_cosine


def get_optimizer(train_cfg) -> Optimizer:
    if train_cfg.optimizer == "adamw":
        return adamw(b1=train_cfg.b1, b2=train_cfg.b2,
                     weight_decay=train_cfg.weight_decay,
                     state_dtype=train_cfg.opt_state_dtype)
    if train_cfg.optimizer == "adafactor":
        return adafactor(weight_decay=train_cfg.weight_decay,
                         state_dtype=train_cfg.opt_state_dtype)
    raise ValueError(train_cfg.optimizer)
