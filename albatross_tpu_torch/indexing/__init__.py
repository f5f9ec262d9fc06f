from .grouping import (
    GroupBy,
    Grouped,
    KFoldGrouper,
    LeaveOneOutGrouper,
    compute_keys,
    group_by,
    indices_complement,
    indices_from_groups,
    unique_value,
    unique_values,
)

__all__ = [k for k in dir() if not k.startswith("_")]
