"""One topology controller over every supervised member kind.

``TopologySpec`` declares WHAT should be running (router, thread or
process replicas + transport, grid workers, broker) as journal-able
data; ``TopologyController`` supervises the live inventory against that
declaration — distinct killed/hung/ring-stalled classification, repair
verbs that reuse the fleet/pool machinery, fd+segment hygiene sweeps,
and exactly-once recovery of ANY declared shape from the request
journal's topology marks.
"""

from fm_returnprediction_tpu_torch.topology.controller import (
    Member,
    TopologyController,
)
from fm_returnprediction_tpu_torch.topology.spec import TopologySpec

__all__ = ["Member", "TopologyController", "TopologySpec"]
