from .from_jax import flax_to_state_dict

__all__ = ["flax_to_state_dict"]
