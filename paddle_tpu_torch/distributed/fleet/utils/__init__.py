"""Fleet utilities: the data-parallel axis's glue (`hybrid_parallel_util`)."""
from . import hybrid_parallel_util  # noqa: F401
