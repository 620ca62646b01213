from .ops import cuckoo_probe, hash_pair  # noqa
from .ref import reference_cuckoo_probe  # noqa
