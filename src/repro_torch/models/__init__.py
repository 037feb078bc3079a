"""Models: parameter declarations (specs, block programs, init), the
carrying of parameter trees across from the JAX reference, and the forwards
of every registered configuration (full sequence, prefill, decode)."""
from .common import DTYPES, ParamSpec, count_params, is_spec, materialize, spec
from .convert import params_from_jax, params_to_numpy
from .model import Model, build_model

__all__ = ["DTYPES", "Model", "ParamSpec", "build_model", "count_params",
           "is_spec", "materialize", "params_from_jax", "params_to_numpy",
           "spec"]
