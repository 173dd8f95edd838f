from piml_tpu_torch.models.blocks import MLP, ResBlock, ResDNN, activation_fn  # noqa: F401
from piml_tpu_torch.models.convert import (  # noqa: F401
    PRETRAINED,
    load_fixture,
    params_from_flax,
)
from piml_tpu_torch.models.mlapm import (  # noqa: F401
    MLAPMParams,
    mlapm_force,
    mlapm_step,
)
from piml_tpu_torch.models.zoo import (  # noqa: F401
    PINNSF,
    ModelOutput,
    ModelSpec,
    build_finetune_model,
    build_model,
    goal_acceleration,
    pretrain_model_name,
)
