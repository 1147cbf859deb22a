"""repro_torch.agents — deterministic MLE-agent simulators driving stratum
(the port of ``repro.agents``).

No LLM runs in this container; the drivers replay seeded search policies
whose emitted-pipeline statistics match the paper's workload characterization
(Fig. 2) and its §6 evaluation workload.
"""

from .aide import (AIDEAgent, AsyncAIDESearch, PipelineSpec,
                   paper_workload_batches)

__all__ = ["AIDEAgent", "AsyncAIDESearch", "PipelineSpec",
           "paper_workload_batches"]
