from .ops import flash_attention  # noqa
from .ref import reference_attention  # noqa
