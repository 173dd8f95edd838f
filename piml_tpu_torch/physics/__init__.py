from piml_tpu_torch.physics import features  # noqa: F401
from piml_tpu_torch.physics.features import (  # noqa: F401
    NeighborConfig,
    collision_detection,
    collision_detection_single_frame,
    collision_label,
    desired_speed,
    heading_direction,
    history_velocity,
    move_index_matrix,
    nearby_in_sight,
    relative_features,
    turn_detection,
)
from piml_tpu_torch.physics import forces, polar  # noqa: F401,E402
