from .cuckoo import BlockedCuckooStore  # noqa
from .tiered import TimedCuckooStore  # noqa
from . import model  # noqa
