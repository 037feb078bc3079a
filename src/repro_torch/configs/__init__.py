"""Config registry: one module per assigned architecture."""
from .base import (ModelConfig, SHAPES, ShapeConfig, get_config, list_configs,
                   register)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (stablelm_1_6b, gemma2_27b, llama3_2_1b, qwen3_32b,         # noqa
                   deepseek_v3_671b, mixtral_8x22b, jamba_v0_1_52b,           # noqa
                   llama3_2_vision_11b, mamba2_1_3b, hubert_xlarge)           # noqa


ARCHS = (
    "stablelm-1.6b", "gemma2-27b", "llama3.2-1b", "qwen3-32b",
    "deepseek-v3-671b", "mixtral-8x22b", "jamba-v0.1-52b",
    "llama-3.2-vision-11b", "mamba2-1.3b", "hubert-xlarge",
)

__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ShapeConfig", "get_config",
           "list_configs", "register"]
