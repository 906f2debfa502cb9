from bang_jax.ops.pq import (  # noqa: F401
    PQCodebook,
    prepare_pq_codebook,
    pq_distance_tables,
    pq_lookup,
)
from bang_jax.ops.l2 import l2_distance_to_candidates, squared_norms  # noqa: F401
from bang_jax.ops.bloom import (  # noqa: F401
    bloom_hashes,
    bloom_query,
    bloom_insert,
)
from bang_jax.ops.visited import exact_new_mask  # noqa: F401
from bang_jax.ops.merge import merge_worklist, select_parents_beam  # noqa: F401
