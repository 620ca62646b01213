from .ops import ann_topk  # noqa
from .ref import reference_ann_topk, smallest_k  # noqa
