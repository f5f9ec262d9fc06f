from .checkpoint import SERIALIZATION_VERSION, load_checkpoint, save_checkpoint
from .compression import compress, decompress, maybe_decompress
from .params_json import (
    load_params,
    params_from_dict,
    params_from_json,
    params_to_dict,
    params_to_json,
    prior_from_dict,
    prior_to_dict,
    save_params,
)

__all__ = [k for k in dir() if not k.startswith("_")]
