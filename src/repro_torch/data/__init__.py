"""The synthetic data pipeline (the port's copy of `repro.data`)."""
from .pipeline import DataConfig, SyntheticLM, make_batch_specs

__all__ = ["DataConfig", "SyntheticLM", "make_batch_specs"]
