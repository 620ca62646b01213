from . import attention, config, ffn, layers, model  # noqa
from .config import AttnSpec, FfnSpec, ModelConfig  # noqa
