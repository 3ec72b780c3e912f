from crypto_rec_tpu_torch.parallel.mesh import make_mesh, initialize_multihost  # noqa: F401
from crypto_rec_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_rating_set,
    sharded_recommend,
    distributed_topk,
)
from crypto_rec_tpu_torch.parallel.routing import route_queries_by_bucket  # noqa: F401
