from .surface_fitting import (keep_largest_component,  # noqa: F401
                              mesh_to_labelmap, pointcloud_surface_fitting,
                              poisson_reconstruction)
