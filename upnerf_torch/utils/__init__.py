from .weights import init_reference_ckpt, load_reference_ckpt, render_params, state_dict_from_jax

__all__ = ["init_reference_ckpt", "load_reference_ckpt", "render_params", "state_dict_from_jax"]
