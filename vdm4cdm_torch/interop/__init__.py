from .from_jax import opt_state_from_jax, params_from_jax

__all__ = ["opt_state_from_jax", "params_from_jax"]
