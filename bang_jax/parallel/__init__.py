from bang_jax.parallel.base_tp import (  # noqa: F401
    ShardedBaseSearcher,
    make_base_step_tp,
)
from bang_jax.parallel.partition import build_sharded_index, ShardedIndex  # noqa: F401
from bang_jax.parallel.sharded import (  # noqa: F401
    make_mesh,
    search_sharded,
    search_data_parallel,
)
from bang_jax.parallel.pq_tp import (  # noqa: F401
    pq_lookup_tp,
    shard_codes_by_chunk,
    shard_tables_by_chunk,
)
