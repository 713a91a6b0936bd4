from .weights import (
    export_reference_ckpt,
    init_reference_ckpt,
    load_reference_ckpt,
    reference_payload,
    render_params,
    state_dict_from_jax,
    train_modules_from_jax,
)

__all__ = [
    "export_reference_ckpt", "init_reference_ckpt", "load_reference_ckpt", "reference_payload", "render_params", "state_dict_from_jax",
    "train_modules_from_jax",
]
