from . import attention, config, ffn, layers, model, moe  # noqa
from .config import AttnSpec, FfnSpec, ModelConfig, MoeSpec  # noqa
