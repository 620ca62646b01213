from .ops import add_rmsnorm, rmsnorm  # noqa
from .ref import reference_add_rmsnorm, reference_rmsnorm  # noqa
