"""Topology construction and the analytic cost model for the port: GF(q),
the Graph container with batched BFS, PN graphs, the traffic-pattern
registry, the arc-load engines and the routing models."""

from .gf import GF, get_field, is_prime_power
from .graph import (CsrAdjacency, Graph, adjacency_csr, adjacency_dense,
                    bfs_distances_batched)
from .projective import (incidence_lists, normalize_points, num_points,
                         pn_graph, point_index, points)
from .routing import (ROUTINGS, RoutingModel, RoutingResult, blend_optimum,
                      evaluate_models, make_routing, register_routing)
from .traffic import (DEFAULT_SWEEP, PATTERNS, SaturationReport,
                      TrafficPattern, make_pattern, matrix_pattern,
                      normalize_demand, register_pattern, saturation_report,
                      saturation_sweep)
from .utilization import (UtilizationReport, arc_loads, arc_loads_weighted,
                          utilization, valiant_report)

__all__ = [k for k in dir() if not k.startswith("_")]
