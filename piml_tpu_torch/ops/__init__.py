from piml_tpu_torch.ops.pairwise import topk_neighbors_pallas  # noqa: F401
from piml_tpu_torch.ops.banded import (  # noqa: F401
    topk_neighbors_banded,
    topk_neighbors_banded_or_dense,
)
from piml_tpu_torch.ops.grid_pairs import build_cell_index  # noqa: F401
