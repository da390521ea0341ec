"""repro_torch.fabric — the fabric models of the port.  For now only
:func:`torus3d_graph`, the torus the paper's families are compared
with; placement, collectives and the planner are not ported yet."""

from .model import torus3d_graph

__all__ = ["torus3d_graph"]
