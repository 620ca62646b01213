"""The training step and its watchdog (the reference package's
`train`)."""
from . import step, watchdog  # noqa
