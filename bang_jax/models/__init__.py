from bang_jax.models.index import DeviceIndex, device_index_from_files  # noqa: F401
from bang_jax.models.exactdistance import search_exact  # noqa: F401
from bang_jax.models.inmemory import search_inmemory  # noqa: F401
from bang_jax.models.base import BaseVariantSearcher  # noqa: F401
