from .access_models import (get_point_seg_model_class,  # noqa: F401
                            get_seg_cnn_model_class)
from .dg_ssm import DGSSM, dgssm_ensemble_predict  # noqa: F401
from .affine import (AFFINE_MODELS, AffineDGCNN,  # noqa: F401
                     AffineOpenDGCNN, AffinePointNet, PointNetCls)
from .blocks import MLPStack, SharedMLP  # noqa: F401
from .dgcnn import DGCNNReg, DGCNNSeg, EdgeConv  # noqa: F401
from .dgcnn_cls import DGCNNCls, MultiHeadDGCNN  # noqa: F401
from .dpsr_net import DPSRNet, DPSRNet2  # noqa: F401
from .ensemble import build_subsets, ensemble_predict  # noqa: F401
from .folding_net import DGCNNFoldingNet  # noqa: F401
from .io import load_fst, save_fst  # noqa: F401
from .lraspp_3d import LRASPPMobileNetV33D  # noqa: F401
from .point_transformer import PointTransformerSeg  # noqa: F401
from .pointnet import PointNetSeg, TNet  # noqa: F401
from .seg_cnn import (MobileNetASPP, predict_all_patches,  # noqa: F401
                      predict_full_volume)
from .weights import (export_jax_variables, load_fold_model,  # noqa: F401
                      load_jax_variables, load_model, model_class,
                      save_model)
