"""Encoder fine-tuning (port of memex_tpu/train): the embedding model is
adapted to the corpus on the card that serves it."""

from .contrastive import ClipAdamW, TrainConfig, info_nce_loss, init_train_state, make_train_step
from .loop import load_train_state, save_train_state, train_encoder

__all__ = [
    "TrainConfig", "ClipAdamW", "info_nce_loss", "make_train_step",
    "init_train_state", "train_encoder", "save_train_state", "load_train_state",
]
