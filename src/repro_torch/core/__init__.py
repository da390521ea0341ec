"""Topology construction and the analytic cost model for the port: GF(q),
the Graph container with batched BFS, the paper's topology families (PN,
demi-PN, OFT, MLFM, MMS) and the reference topologies, the Moore bounds,
the automorphism orbits, the traffic-pattern registry, the arc-load
engines, the routing models, the fault model, the adversarial harness,
and the cost model with its layout and topology selector."""

from .adversary import (AdversaryReport, adversarial_report,
                        adversarial_table, worst_case)
from .cost import (CostParams, DirectNetworkSpec, cost_figure,
                   dollars_per_node, max_terminals_per_router,
                   network_summary, watts_per_node)
from .faults import (DegradationSweep, FaultReport, FaultSet,
                     degradation_sweep, degraded_report, fault_report,
                     random_faults, targeted_faults)
from .gf import GF, get_field, is_prime_power, prime_power_decompose
from .graph import (CsrAdjacency, Graph, adjacency_csr, adjacency_dense,
                    bfs_distances, bfs_distances_batched,
                    distance_distribution)
from .layout import cable_split, electrical_groups, group_sizes
from .mms import mms_eps, mms_generator_sets, mms_graph
from .moore import (generalized_moore_distribution, generalized_moore_kbar,
                    kbar_approx, min_kbar, moore_bound,
                    moore_distance_distribution, terminals_bound)
from .orbits import OrbitInfo, automorphism_generators, orbit_info
from .projective import (demi_pn_graph, incidence_lists, mlfm_graph,
                         normalize_points, num_points, oft_graph, pn_graph,
                         point_index, points, self_orthogonal_points,
                         subplane_classes, subplane_line_classes)
from .reference import (complete_bipartite_graph, complete_graph,
                        dragonfly_canonical_stats, dragonfly_graph,
                        hamming_graph, hypercube_graph, paley_graph,
                        random_regular_graph, turan_graph)
from .registry import TOPOLOGIES, build_topology
from .routing import (ROUTINGS, RoutingModel, RoutingResult, blend_optimum,
                      evaluate_models, make_routing, register_routing)
from .select import (Realization, all_realizations, realizations_for_family,
                     select_topology)
from .traffic import (DEFAULT_SWEEP, PATTERNS, SaturationReport,
                      TrafficPattern, make_pattern, matrix_pattern,
                      normalize_demand, register_pattern, saturation_report,
                      saturation_sweep)
from .utilization import (UtilizationReport, arc_loads, arc_loads_weighted,
                          utilization, valiant_report)

__all__ = [k for k in dir() if not k.startswith("_")]
