from .ops import reuse_sketch_update  # noqa
from .ref import bucket_of, reference_reuse_sketch  # noqa
