from piml_tpu_torch.metrics.metrics import (  # noqa: F401
    collision_count,
    mae_with_time_mask,
)
