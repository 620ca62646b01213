from . import corpus, model, progressive  # noqa
