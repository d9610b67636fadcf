"""Synthetic token data pipeline."""

from .pipeline import DataConfig, synthetic_batches

__all__ = ["DataConfig", "synthetic_batches"]
