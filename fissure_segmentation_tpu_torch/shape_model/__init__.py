from .lssm import fit_lssm  # noqa: F401
from .ssm import (SSMParams, fit_ssm, load_ssm, save_ssm,  # noqa: F401
                  ssm_decode, ssm_project, ssm_random_samples)
