"""The synthetic data pipeline (the reference package's `data`)."""
from .pipeline import DataConfig, PrefetchIterator, SyntheticLM  # noqa
