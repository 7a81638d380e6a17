from .bucket_cost import bucket_cost_packed, load_catalog
from .feasibility import availability_counts, bucket_type_cost, bucket_type_cost_packed
from .warmfill import warm_fill_counts, warm_fill_counts_device, warm_fill_counts_np

__all__ = [
    "availability_counts",
    "bucket_cost_packed",
    "bucket_type_cost",
    "bucket_type_cost_packed",
    "load_catalog",
    "warm_fill_counts",
    "warm_fill_counts_device",
    "warm_fill_counts_np",
]
