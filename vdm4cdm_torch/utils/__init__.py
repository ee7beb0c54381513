from .array import count_params, nchw_to_nlast, nlast_to_nchw, to_np
from .rng import RngStream, seeded_generator

__all__ = ["RngStream", "count_params", "nchw_to_nlast", "nlast_to_nchw",
           "seeded_generator", "to_np"]
