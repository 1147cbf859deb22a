"""repro_torch.core — stratum: execution infrastructure for agentic
pipeline search (the port of ``repro.core``).

The paper's contribution (§4), as a composable library:

* :mod:`repro_torch.core.dag`         lazy operator DAG + content hashing
* :mod:`repro_torch.core.fusion`      pipeline-batch fusion, variant grouping
* :mod:`repro_torch.core.metadata`    metadata collection pass
* :mod:`repro_torch.core.rewrites`    CSE / read sharing / pushdown / folding
* :mod:`repro_torch.core.lowering`    composite-operator lowering (CV unrolling...)
* :mod:`repro_torch.core.selection`   tiered physical operator selection
* :mod:`repro_torch.core.scheduler`   memory-budgeted parallelization planning
* :mod:`repro_torch.core.cache`       intermediate reuse (RAM/device + disk spill)
* :mod:`repro_torch.core.plan_cache`  compiled-plan cache (structural signatures)
* :mod:`repro_torch.core.runtime`     segment executor, the boundary between tiers
* :mod:`repro_torch.core.backends`    ExecutionBackend seam (per-op, compiled)
* :mod:`repro_torch.core.analysis`    pre-flight static analysis
* :mod:`repro_torch.core.api`         the Stratum session
"""

from .api import ALL_FEATURES, Stratum, StratumReport
from .backends import (ExecutionBackend, PythonThreadBackend, make_backends,
                       register_backend)
from .dag import (COMPOSITE, CONST, ESTIMATOR, EVAL, FILTER, GENERIC, LazyOp,
                  LazyRef, PROJECT, SOURCE, TRANSFORM, count_ops,
                  declare_tunable, structural_signature, toposort,
                  tunable_fields)
from .fusion import PipelineBatch, group_variants
from .plan_cache import PlanCache
from .annotations import annotate

__all__ = [
    "ALL_FEATURES", "Stratum", "StratumReport", "LazyOp", "LazyRef",
    "PipelineBatch", "group_variants", "annotate", "count_ops", "toposort",
    "declare_tunable", "tunable_fields", "structural_signature",
    "ExecutionBackend", "PythonThreadBackend",
    "make_backends", "register_backend", "PlanCache",
    "SOURCE", "TRANSFORM", "PROJECT", "FILTER", "ESTIMATOR", "EVAL",
    "COMPOSITE", "CONST", "GENERIC",
]
