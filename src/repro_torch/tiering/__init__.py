from .expert_store import ExpertStore  # noqa
