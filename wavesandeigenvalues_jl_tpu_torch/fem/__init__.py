from .assembly import aggregate_elements, scatter_vector
from .bloch import BlochContext
from ..mesh.annular import bloch_expand
from . import elements

__all__ = ["aggregate_elements", "scatter_vector", "BlochContext",
           "bloch_expand", "elements"]
