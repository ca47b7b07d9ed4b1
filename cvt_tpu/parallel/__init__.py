"""Device-mesh parallelism: sharded ADC search and distributed training.

The reference has NO multi-process/multi-node layer (SURVEY.md §2.5: no
MPI/NCCL/Gloo anywhere — parallelism is OpenMP threads + AVX). This
package is the new distributed surface required by BASELINE.json:
database sharding over a device mesh with XLA collectives.
"""

from cvt_tpu.parallel.mesh import make_mesh, cpu_mesh
from cvt_tpu.parallel.sharded_search import ShardedADCSearcher
from cvt_tpu.parallel.distributed_kmeans import sharded_kmeans_step
from cvt_tpu.parallel.serving import (MultiHostADCServer, QueryBatcher,
                                      init_distributed, serving_mesh,
                                      ring_merge_topk)

__all__ = ["make_mesh", "cpu_mesh", "ShardedADCSearcher",
           "sharded_kmeans_step", "MultiHostADCServer", "QueryBatcher",
           "init_distributed", "serving_mesh", "ring_merge_topk"]
