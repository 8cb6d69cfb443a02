from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_param_count,
    tree_map_with_name,
    flatten_names,
)
from repro_torch.utils.timing import Timer, time_call
