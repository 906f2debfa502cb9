from bang_jax.utils.config import SearchParams, DATASET_PRESETS  # noqa: F401
from bang_jax.utils.recall import calculate_recall  # noqa: F401
from bang_jax.utils.timer import CPUTimer, StageTimers  # noqa: F401
from bang_jax.utils.logging import log_message  # noqa: F401
