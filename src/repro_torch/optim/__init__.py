"""AdamW (the reference package's `optim`)."""
from . import adamw  # noqa
