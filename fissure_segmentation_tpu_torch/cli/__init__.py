"""Command-line flags of the entry points (a copy of the JAX package's cli,
which needs only argparse, json and os)."""
from .args import (get_generic_parser, get_dgcnn_train_parser,  # noqa: F401
                   get_point_segmentation_parser, get_dpsr_train_parser,
                   get_seg_cnn_train_parser, get_dgcnn_ssm_train_parser,
                   get_pc_ae_train_parser, get_ae_reg_parser)
from .utils import store_args, load_args, load_args_dict, load_args_for_testing  # noqa: F401
