from piml_tpu_torch.data.datasets import channel_batches  # noqa: F401
from piml_tpu_torch.data.views import (  # noqa: F401
    ChanneledData,
    TimeIndexedData,
    make_time_indexed,
    neighbor_config,
    to_channeled,
    window_slice,
)
