from .clibd import CLIBD, clibd_apply, init_clibd_model, l2_normalize, set_trainable
from .convert import load_params_npz, model_from_jax, params_from_jax

__all__ = [
    "CLIBD",
    "clibd_apply",
    "init_clibd_model",
    "l2_normalize",
    "load_params_npz",
    "model_from_jax",
    "params_from_jax",
    "set_trainable",
]
