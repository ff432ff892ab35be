from . import ape
from .ape import compute_potflow_field
from .helmholtz import discretize
from .network import discretize_network
from .rijke import (active_rijke_family, active_rijke_setup,
                    large_operator_family, passive_rijke_setup)
from .shape import (blochify_surface_points, bound_mass_normalize,
                    discrete_adjoint_shape_sensitivity,
                    forward_finite_differences_shape_sensitivity,
                    get_surface_point_masks, normal_sensitivity,
                    normalize_sensitivity, surface_normal_vectors)

__all__ = ["ape", "compute_potflow_field", "discretize", "discretize_network",
           "discrete_adjoint_shape_sensitivity",
           "forward_finite_differences_shape_sensitivity",
           "normalize_sensitivity", "bound_mass_normalize",
           "normal_sensitivity", "get_surface_point_masks",
           "surface_normal_vectors", "blochify_surface_points",
           "active_rijke_family", "active_rijke_setup",
           "large_operator_family", "passive_rijke_setup"]
