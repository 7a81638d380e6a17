from .bucket_cost import bucket_cost_keyed, bucket_cost_packed, load_catalog
from .feasibility import availability_counts, bucket_type_cost, bucket_type_cost_keyed, bucket_type_cost_packed
from .packing import audit_layout, segment_usage
from .warmfill import warm_fill_counts, warm_fill_counts_device, warm_fill_counts_np

__all__ = [
    "audit_layout",
    "availability_counts",
    "bucket_cost_keyed",
    "bucket_cost_packed",
    "bucket_type_cost",
    "bucket_type_cost_keyed",
    "bucket_type_cost_packed",
    "load_catalog",
    "segment_usage",
    "warm_fill_counts",
    "warm_fill_counts_device",
    "warm_fill_counts_np",
]
