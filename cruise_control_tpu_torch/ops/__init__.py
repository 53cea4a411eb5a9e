"""Device ops of the search: the fused cost, the K×D move grid (with its
hand-written terms and top-R kernels), the candidate-pool tables and
deterministic segment sums."""

from cruise_control_tpu_torch.ops.cost import broker_cost
from cruise_control_tpu_torch.ops.grid import (
    grid_rescore,
    move_grid_scores,
    move_grid_terms,
)

__all__ = ["broker_cost", "grid_rescore", "move_grid_scores",
           "move_grid_terms"]
