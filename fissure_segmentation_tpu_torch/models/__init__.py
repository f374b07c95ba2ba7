from .access_models import (get_point_seg_model_class,  # noqa: F401
                            get_seg_cnn_model_class)
from .dgcnn import DGCNNSeg, EdgeConv  # noqa: F401
from .ensemble import build_subsets, ensemble_predict  # noqa: F401
from .point_transformer import PointTransformerSeg  # noqa: F401
from .seg_cnn import (MobileNetASPP, predict_all_patches,  # noqa: F401
                      predict_full_volume)
from .weights import (export_jax_variables, load_jax_variables,  # noqa: F401
                      load_model, save_model)
