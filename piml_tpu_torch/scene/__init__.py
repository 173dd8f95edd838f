from piml_tpu_torch.scene import codec  # noqa: F401
from piml_tpu_torch.scene.scene import (  # noqa: F401
    Scene,
    crop,
    mirror,
    random_walk_noise,
    rotate,
)
