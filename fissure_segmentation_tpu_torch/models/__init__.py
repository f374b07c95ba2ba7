from .access_models import (get_point_seg_model_class,  # noqa: F401
                            get_seg_cnn_model_class)
from .dgcnn import DGCNNSeg, EdgeConv  # noqa: F401
from .ensemble import build_subsets, ensemble_predict  # noqa: F401
from .folding_net import DGCNNFoldingNet  # noqa: F401
from .io import load_fst, save_fst  # noqa: F401
from .lraspp_3d import LRASPPMobileNetV33D  # noqa: F401
from .point_transformer import PointTransformerSeg  # noqa: F401
from .seg_cnn import (MobileNetASPP, predict_all_patches,  # noqa: F401
                      predict_full_volume)
from .weights import (export_jax_variables, load_fold_model,  # noqa: F401
                      load_jax_variables, load_model, model_class,
                      save_model)
