from .ops import decode_attention  # noqa
from .ref import reference_decode_attention  # noqa
