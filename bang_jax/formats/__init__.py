from bang_jax.formats.bin_io import (  # noqa: F401
    load_bin,
    save_bin,
    load_truthset,
    save_truthset,
)
from bang_jax.formats.graph import (  # noqa: F401
    GraphMetadata,
    GraphIndex,
    load_graph_index,
    save_graph_index,
    load_metadata,
    save_metadata,
)
from bang_jax.formats.pq import (  # noqa: F401
    PQData,
    load_pq_pivots,
    save_pq_pivots,
    load_pq_compressed,
    save_pq_compressed,
)
