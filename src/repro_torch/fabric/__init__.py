"""repro_torch.fabric — the fabric layer of the port: collective times
on the saturation model, :class:`FabricModel`, the placement pipeline
(mesh -> routers -> demand -> routing models), the planner and the
multi-tenant fragmentation sweep.  Every name of ``repro.fabric``;
everything that routes runs on the card unless ``device="cpu"`` is
passed."""

from .collectives import (CollectiveCost, allgather_time, allreduce_time,
                          alltoall_time, bytes_on_wire, collective_time,
                          reducescatter_time)
from .model import FabricModel, make_fabric, torus3d_graph
from .placement import (PLACEMENT_STRATEGIES, Placement, PlacementStrategy,
                        collective_traffic, evaluate_placements,
                        greedy_improve, link_loads, make_placement_strategy,
                        place_mesh, placement_demand, placement_report,
                        placement_search, register_placement,
                        schedule_from_profile)
from .planner import (FabricCandidate, StepProfile, candidate_fabrics,
                      fragmentation_sweep, placement_step_seconds, plan)
