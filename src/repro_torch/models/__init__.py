from . import attention, config, ffn, layers, model, moe, ssm  # noqa
from .config import AttnSpec, FfnSpec, Mamba2Spec, ModelConfig, MoeSpec  # noqa
