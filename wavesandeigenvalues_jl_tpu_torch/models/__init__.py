from .helmholtz import discretize
from .rijke import (active_rijke_family, active_rijke_setup,
                    large_operator_family, passive_rijke_setup)

__all__ = ["discretize", "active_rijke_family", "active_rijke_setup",
           "large_operator_family", "passive_rijke_setup"]
