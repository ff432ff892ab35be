from .assembly import aggregate_elements, scatter_matrix, scatter_vector
from .bloch import BlochContext
from ..mesh.annular import bloch_expand
from .getters import get_n_grad_p, get_p
from . import elements

__all__ = ["aggregate_elements", "scatter_matrix", "scatter_vector",
           "elements", "get_p", "get_n_grad_p", "bloch_expand",
           "BlochContext"]
