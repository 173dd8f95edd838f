from piml_tpu_torch.models.blocks import (  # noqa: F401
    MLP,
    AttnPooling,
    ResBlock,
    ResDNN,
    activation_fn,
)
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
    BaseSim,
    BaseTest,
    ModelOutput,
    ModelSpec,
    apply_collision_rules,
    build_finetune_model,
    build_model,
    goal_acceleration,
    pretrain_model_name,
)
