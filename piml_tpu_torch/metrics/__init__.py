from piml_tpu_torch.metrics.metrics import (  # noqa: F401
    collision_count,
    mae_with_time_mask,
    mmd_masked,
    mmd_masked_chunked,
    mmd_with_time_mask,
    ot_with_time_mask,
    sinkhorn_masked,
    sinkhorn_masked_chunked,
)
from piml_tpu_torch.metrics.ot_banded import (  # noqa: F401
    ot_banded_params,
    sinkhorn_banded,
    sinkhorn_banded_or_dense,
)
