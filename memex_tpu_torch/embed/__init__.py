"""Sentence encoding on the device (port of memex_tpu/embed)."""

from .engine import EmbeddingEngine

__all__ = ["EmbeddingEngine"]
