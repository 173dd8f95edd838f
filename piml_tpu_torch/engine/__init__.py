from piml_tpu_torch.engine.rollout import (  # noqa: F401
    EngineConfig,
    EngineState,
    SpawnFrame,
    StepOutputs,
    batched_rollout,
    init_state,
    make_features_fn,
    make_step,
    rollout,
    select_waypoint,
    spawn_frames_from_scene,
)
from piml_tpu_torch.engine.simulator import (  # noqa: F401
    RolloutMetrics,
    RolloutResult,
    TrainingRolloutLoss,
    engine_config,
    eval_rollout,
    evaluate_rollouts,
    post_process,
    training_rollout_loss,
)
