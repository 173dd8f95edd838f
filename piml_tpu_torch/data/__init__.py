from piml_tpu_torch.data.views import (  # noqa: F401
    TimeIndexedData,
    make_time_indexed,
    neighbor_config,
)
