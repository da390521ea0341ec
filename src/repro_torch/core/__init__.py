"""Topology construction for the port: GF(q), the Graph container with
batched BFS, PN graphs and the traffic-pattern registry."""

from .gf import GF, get_field, is_prime_power
from .graph import Graph, bfs_distances_batched
from .projective import (incidence_lists, normalize_points, num_points,
                         pn_graph, point_index, points)
from .traffic import (PATTERNS, TrafficPattern, make_pattern,
                      matrix_pattern, normalize_demand)

__all__ = ["GF", "get_field", "is_prime_power", "Graph",
           "bfs_distances_batched", "incidence_lists", "normalize_points",
           "num_points", "pn_graph", "point_index", "points", "PATTERNS",
           "TrafficPattern", "make_pattern", "matrix_pattern",
           "normalize_demand"]
