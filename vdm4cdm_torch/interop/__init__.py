from .from_jax import opt_state_from_jax, params_from_jax
from .from_torch import params_from_torch, strip_and_rename

__all__ = ["opt_state_from_jax", "params_from_jax", "params_from_torch",
           "strip_and_rename"]
