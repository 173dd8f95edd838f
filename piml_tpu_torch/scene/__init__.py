from piml_tpu_torch.scene import codec  # noqa: F401
from piml_tpu_torch.scene.scene import Scene  # noqa: F401
