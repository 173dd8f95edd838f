from piml_tpu_torch.utils.logging import MetricLogger  # noqa: F401
from piml_tpu_torch.utils.analysis import rollout_mae_powerlaw  # noqa: F401
from piml_tpu_torch.utils import profiling  # noqa: F401
