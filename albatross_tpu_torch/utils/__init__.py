from .chebyshev import chebyshev_t, chebyshev_t_phi, chebyshev_u
from .csv import read_csv_columns, read_csv_dataset, write_to_csv
from .graph import (
    Edge,
    Graph,
    compute_vertices,
    create_graph,
    maximum_spanning_forest,
    maximum_spanning_tree,
    minimum_spanning_forest,
    minimum_spanning_tree,
)
from .profiling import named_scope, trace, wall_timer
from .random import (
    random_covariance_matrix,
    random_without_replacement,
    sample_mvn,
)

__all__ = [k for k in dir() if not k.startswith("_")]
