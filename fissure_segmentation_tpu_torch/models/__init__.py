from .dgcnn import DGCNNSeg, EdgeConv  # noqa: F401
from .ensemble import build_subsets, ensemble_predict  # noqa: F401
from .weights import (export_jax_variables, load_jax_variables,  # noqa: F401
                      load_model, save_model)
