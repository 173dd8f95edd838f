"""Multi-rank parallelism over ``torch.distributed`` (counterpart of
``piml_tpu/parallel``): channel data parallelism, the agent-sharded pair
pass with K2's multi-rank caller, sharded OT / MMD and tensor
parallelism.  One process per rank; every sharded function takes the same
full inputs on every rank and returns the full result on every rank."""

from piml_tpu_torch.parallel.sharding import (  # noqa: F401
    make_dp_finetune_step,
    make_dp_pointwise_step,
    make_mesh,
    replicate,
    pad_channels,
    pad_channels_stacked,
    shard_channeled_batch,
    shard_stacked_channeled,
    shard_leading,
)
from piml_tpu_torch.parallel.agent_shard import (  # noqa: F401
    sharded_banded_features,
    ring_topk_neighbors,
    sharded_relative_features,
)
from piml_tpu_torch.parallel.metrics_shard import (  # noqa: F401
    sharded_mmd,
    sharded_mmd_with_time_mask,
    sharded_ot_with_time_mask,
    sharded_sinkhorn,
)
from piml_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    gather_params_tp,
    make_tp_apply,
    make_tp_dp_finetune_step,
    shard_params_tp,
    tp_param_shardings,
)
from piml_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    is_multi_host,
    spawn_local,
)
