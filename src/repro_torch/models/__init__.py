"""Model substrate: configs, blocks and the assembled decoder `Model`
(the port's copy of `repro.models`)."""
from .config import ModelConfig
from .transformer import Model

__all__ = ["Model", "ModelConfig"]
