"""Correlation Sketches core: the paper's contribution as a PyTorch
library (sketches, sketch joins, estimators, bounds, scorers, top-k)."""
from repro_torch.core.sketch import (  # noqa: F401
    Agg,
    CorrelationSketch,
    build_sketch,
    build_sketch_cols,
    build_sketch_streaming,
    empty_sketch_cols,
    merge,
    stack_sketches,
)
from repro_torch.core.join import SketchJoin, sketch_join  # noqa: F401
from repro_torch.core.bounds import (  # noqa: F401
    CorrelationCI,
    containment_ci,
    fisher_z_se,
    hoeffding_ci,
)
from repro_torch.core.scoring import CandidateStats, score, SCORERS  # noqa: F401
from repro_torch.core.ranking import (  # noqa: F401
    QueryResult,
    candidate_stats,
    topk_query,
)
from repro_torch.core.containment import (  # noqa: F401
    JoinabilityEstimates,
    joinability_estimates,
)
from repro_torch.core import containment  # noqa: F401
from repro_torch.core import estimators  # noqa: F401
from repro_torch.core import hashing  # noqa: F401
