"""The model module of a config: counterpart of ``model_module`` in
``repro/launch/specs.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm, vision_lm


def model_module(cfg: ModelConfig):
    """``models.vision_lm`` for the vlm family, ``models.encdec`` for
    encdec, else ``models.lm``."""
    return {"vlm": vision_lm, "encdec": encdec}.get(cfg.family, lm)
