from . import weight_convert

jax_variables_to_state_dict = weight_convert.jax_variables_to_state_dict

__all__ = ["jax_variables_to_state_dict"]
