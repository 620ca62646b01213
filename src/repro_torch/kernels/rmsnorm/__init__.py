from .ops import rmsnorm  # noqa
from .ref import reference_rmsnorm  # noqa
