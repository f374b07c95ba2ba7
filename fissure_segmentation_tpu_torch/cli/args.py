"""Layered argparse CLI, flag-compatible with the reference
(cli/cli_args.py:10-192): a generic parser (training / data / test groups)
specialized per model family.

A copy of the JAX package's cli/args.py, flag for flag, so that both
entry points parse the same command line into the same namespace (pinned by
tests/test_torch_repairs.py). In the port `--gpu` picks the CUDA card.
"""
from __future__ import annotations

import argparse
import json

KP_MODES = ["foerstner", "noisy", "cnn", "enhancement"]
FEATURE_MODES = ["mind", "mind_ssc", "image", "enhancement"]
SHAPE_TYPES = ["sphere", "gaussian", "plane"]
CORRESPONDENCE_MODES = ["simple", "cpd"]
LOSS_CHOICES = ["nnunet", "ce", "recall", "ssm", "chamfer", "mesh", "dpsr"]


def add_training_parameters(parser):
    group = parser.add_argument_group("Training Parameters")
    group.add_argument("--epochs", default=1000, type=int, help="max. number of epochs")
    group.add_argument("--lr", default=0.001, type=float, help="learning rate")
    group.add_argument("--batch", default=32, type=int, help="batch size")
    group.add_argument("--loss", default="nnunet", type=str, choices=LOSS_CHOICES,
                       help='loss function for training. "nnunet" is cross entropy '
                            '+ DICE loss, "recall" is weighted cross entropy that '
                            "promotes recall.")
    group.add_argument("--loss_weights", nargs="+", default=None, type=float,
                       help="Weights for the components of loss function.")
    group.add_argument("--wd", default=1e-5, type=float,
                       help="weight decay parameter for Adam optimizer")
    group.add_argument("--scheduler", default="plateau", type=str,
                       choices=["cosine", "plateau", "none"],
                       help="the learn rate scheduler to use")
    group.add_argument("--all_in_gpu", action="store_true",
                       help="(parity flag; data always lives device-side here)")
    group.add_argument("--amp", default=True,
                       type=lambda s: s.lower() not in ("0", "false", "no"),
                       help="mixed-precision compute (bfloat16 matmuls, f32 "
                            "params) — the TPU analog of the reference's "
                            "AMP autocast, which is on by default for seg "
                            "losses (model_trainer.py:75,157). Pass "
                            "--amp false for full f32.")


def add_test_parameters(parser):
    group = parser.add_argument_group("Testing Parameters")
    group.add_argument("--test_only", const=True, default=False, nargs="?",
                       help="do not train model")
    group.add_argument("--train_only", const=True, default=False, nargs="?",
                       help="do not test model")
    group.add_argument("--fold", default=None, type=int,
                       help="specify if only one fold should be evaluated")
    group.add_argument("--copd", const=True, default=False, nargs="?",
                       help="validate model on COPD data set (disables cross-validation)")


def add_data_parameters(parser):
    group = parser.add_argument_group("Data Parameters")
    group.add_argument("--data", default="fissures", type=str,
                       choices=["fissures", "lobes"], help="type of labels")
    group.add_argument("--ds", default="data", type=str, choices=["data", "ts", "synthetic"],
                       help="dataset to use ('synthetic' generates cases on the fly)")
    group.add_argument("--data_dir", default=None, type=str,
                       help="directory containing *_points_*.npz case files")
    group.add_argument("--kp_mode", default="foerstner", type=str, choices=KP_MODES,
                       help="keypoint extraction mode")
    group.add_argument("--exclude_rhf", const=True, default=False, nargs="?",
                       help="exclude the right horizontal fissure from the model")
    group.add_argument("--split", default=None, type=str,
                       help="cross validation split file")
    group.add_argument("--binary", const=True, default=False, nargs="?",
                       help="binary fissure/no-fissure classification")


def get_generic_parser(description: str):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--gpu", default=0, type=int,
                        help="(parity flag) device index")
    parser.add_argument("--output", default="./results", type=str,
                        help="output data path")
    parser.add_argument("--show", const=True, default=False, nargs="?",
                        help="turn on plots (will only be saved by default)")
    parser.add_argument("--offline", const=True, default=False, nargs="?",
                        help="Run detached via nohup, log to ./results/logs/")
    parser.add_argument("--speed", const=True, default=False, nargs="?",
                        help="Run inference speed test (nothing else)")
    parser.add_argument("--dp", const=True, default=False, nargs="?",
                        help="data-parallel training: shard the batch over "
                             "all local devices (batch must be divisible)")
    parser.add_argument("--visualize", default=None, type=int, nargs="?",
                        const=1, metavar="EVERY",
                        help="render the validation batch every EVERY epochs "
                             "(default 1 when given) to fold_dir/"
                             "visualizations/ (model_trainer.py:35-39 hook)")
    add_training_parameters(parser)
    add_data_parameters(parser)
    add_test_parameters(parser)
    return parser


def get_dgcnn_train_parser():
    parser = get_generic_parser("Train DGCNN for lung fissure segmentation.")
    group = parser.add_argument_group("DGCNN parameters")
    group.add_argument("--k", default=20, type=int,
                       help="number of neighbors for graph computation")
    group.add_argument("--pts", default=1024, type=int,
                       help="number of points per forward pass")
    group.add_argument("--coords", const=True, default=False, nargs="?",
                       help="use point coords as features")
    group.add_argument("--patch", default=None, type=str,
                       help=f"use image patch around points as features, one of {FEATURE_MODES}")
    group.add_argument("--transformer", const=True, default=False, nargs="?",
                       help="use spatial transformer module in DGCNN")
    group.add_argument("--static", const=True, default=False, nargs="?",
                       help="do not use dynamic graph computation in DGCNN")
    group.add_argument("--img_feat_extractor", const=True, default=False, nargs="?",
                       help="use an extra image feature extraction module")
    group.add_argument("--knn_recall", default=None, type=float,
                       help="TPU-only speed knob (no reference equivalent): "
                            "build kNN graphs approximately at this "
                            "per-neighbor recall target (e.g. 0.9 measures "
                            "0.97 actual recall and ~18%% faster training "
                            "steps); default exact graphs")
    parser.set_defaults(scheduler="cosine")
    return parser


def get_point_segmentation_parser():
    parser = get_dgcnn_train_parser()
    group = parser.add_argument_group("Model Choice")
    group.add_argument("--model", choices=["PointNet", "DGCNN", "PointTransformer"],
                       default="DGCNN", help="segmentation model class")
    return parser


def get_dpsr_train_parser():
    parser = get_point_segmentation_parser()
    parser.description = ("Train Point Segmentation with differentiable PSR "
                          "for lung fissure segmentation")
    group = parser.add_argument_group("DPSR parameters")
    group.add_argument("--res", default=(128, 128, 128), type=int, nargs=3,
                       help="resolution of the PSR grid")
    group.add_argument("--normals_sigma", default=10, type=float,
                       help="degree of gaussian smoothing of normals grid")
    group.add_argument("--sigma", default=10, type=float,
                       help="degree of gaussian smoothing in DPSR")
    group.add_argument("--dpsr_version", default=2, type=int, choices=(1, 2),
                       help="1: per-class point extraction + estimated "
                            "normals (reference models/dpsr_net.py DPSRNet); "
                            "2: SoftMesh logit splatting (seg_logits_to_mesh"
                            ".py DPSRNet2, the paper's main variant)")
    parser.set_defaults(loss="dpsr")
    return parser


def get_seg_cnn_train_parser():
    parser = get_generic_parser("Train 3D CNN for lung fissure segmentation.")
    group = parser.add_argument_group("3D CNN parameters")
    group.add_argument("--model", choices=["v1", "v3"], default="v1",
                       help="MobilenetV1+ASPP or MobilenetV3+LR-ASPP")
    group.add_argument("--patch_size", default=96, type=int,
                       help="patch size used for each dimension during training")
    group.add_argument("--spacing", default=1.5, type=float,
                       help="isotropic resample to this spacing (in mm)")
    return parser


def get_dgcnn_ssm_train_parser():
    parser = get_dgcnn_train_parser()
    parser.description = "Train DGCNN-Shape-Model Regression for lung fissure segmentation"
    group = parser.add_argument_group("SSM parameters")
    group.add_argument("--alpha", default=3.0, type=float,
                       help="Multiplier for plausible shape range (+-alpha*std.dev.)")
    group.add_argument("--target_variance", default=0.95, type=float,
                       help="Fraction of the dataset variance explained by the model")
    group.add_argument("--lssm", const=True, default=False, nargs="?",
                       help="use Localized SSM instead of standard SSM")
    group.add_argument("--predict_affine", const=True, default=False, nargs="?",
                       help="predict the affine transformation of corresponding points")
    group.add_argument("--corr_mode", default="simple", choices=CORRESPONDENCE_MODES,
                       type=str, help="mode of the point correspondence generation")
    group.add_argument("--head_schedule", type=json.loads,
                       default={"main": 150, "translation": 0, "rotation": 100,
                                "scaling": 50},
                       help="json: epoch at which each head activates")
    group.add_argument("--only_affine", const=True, default=False, nargs="?",
                       help="only train the affine heads")
    parser.set_defaults(loss="ssm")
    return parser


def get_pc_ae_train_parser():
    parser = get_dgcnn_train_parser()
    parser.description = "Train DGCNN+FoldingNet Encoder+Decoder"
    group = parser.add_argument_group("FoldingNet parameters")
    group.add_argument("--latent", default=512, type=int,
                       help="Dimensionality of latent shape code (z).")
    group.add_argument("--shape", choices=SHAPE_TYPES, default="plane",
                       help="Shape type folded by the FoldingNet decoder.")
    group.add_argument("--mesh", default=False, const=True, nargs="?",
                       help="Decode a mesh instead of a point cloud.")
    group.add_argument("--deform", default=False, const=True, nargs="?",
                       help="Use deforming decoder instead of folding.")
    group.add_argument("--obj", type=int, default=None,
                       help="Only use the object with this index.")
    group.add_argument("--dec_depth", type=int, default=2,
                       help="Number of folding/deforming layers in the decoder.")
    parser.set_defaults(loss="mesh")
    return parser


def get_ae_reg_parser():
    parser = get_generic_parser(
        "Prediction of the segmentation DGCNN regularized by the PC-AE (test-only).")
    group = parser.add_argument_group("AE-regularization parameters")
    group.add_argument("--seg_dir", type=str, required=True,
                       help="Cross-validation directory of the segmentation DGCNN.")
    group.add_argument("--ae_dir", type=str, required=True,
                       help="Cross-validation directory of the PC-AE.")
    group.add_argument("--sampling", choices=["farthest", "accumulate"],
                       default="farthest", type=str)
    group.add_argument("--pad_with_random_offsets", action="store_true")
    parser.set_defaults(test_only=True)
    return parser
