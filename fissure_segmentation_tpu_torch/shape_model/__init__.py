from .lssm import fit_lssm  # noqa: F401
from .ssm import (SSMParams, fit_ssm, load_ssm, save_ssm,  # noqa: F401
                  ssm_decode, ssm_project, ssm_random_samples)
from .registration import (TPS, register_cpd_deformable,  # noqa: F401
                           register_cpd_rigid, thin_plate_dense)
from .correspondences import (generate_corresponding_points,  # noqa: F401
                              load_corresponding_points,
                              save_corresponding_points)
from .qualitative import (latent_interpolation, load_shape_npz,  # noqa: F401
                          sample_shapes_to_npz, visualize_reconstruction,
                          visualize_ssm_samples)
from .adam_registration import (dense_adam_registration,  # noqa: F401
                                landmark_tre_mm, register_images,
                                registration_features, upsample_displacement,
                                warp_volume)
