from .adamw import (  # noqa: F401
    AdamState,
    AdamW,
    cosine_schedule,
    global_norm,
    tree_leaves,
    tree_map,
)
