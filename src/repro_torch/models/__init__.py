from . import attention, config, ffn, layers, model, moe, ssm, xlstm  # noqa
from .config import (AttnSpec, FfnSpec, Mamba2Spec, MLstmSpec,  # noqa
                     ModelConfig, MoeSpec, SLstmSpec)
