"""The parallel layer on torch.distributed (counterpart of the JAX
package's parallel/): data-parallel training lives in the trainer
(train/trainer.py `group=`), the global-batch statistics in the BatchNorm
and the losses (ops/collectives.py); this package holds the mesh, the
sharded serving ensemble, the ring kNN and the z-slab sliding window, and
`dryrun.py` drives them all."""
from ..models.blocks import convert_sync_batchnorm  # noqa: F401
from .mesh import (Mesh, all_gather, make_mesh, ppermute,  # noqa: F401
                   replicate, shard_along, spawn)
from .ensemble import sharded_ensemble_predict  # noqa: F401
from .spatial import (halo_exchange, halo_reduce, halo_exchange_down,  # noqa: F401
                      halo_reduce_down, sharded_predict_all_patches)
from .points import (sharded_knn, sharded_gather_neighbors,  # noqa: F401
                     sharded_edge_features)
