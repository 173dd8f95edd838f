from piml_tpu_torch.data.datasets import (  # noqa: F401
    FinetuneDataset,
    OnlyTrainingDataset,
    PointwiseDataset,
    RatioSplitDataset,
    SceneListSplitDataset,
    VisDataset,
    apply_config_augmentation,
    augment_scenes,
    channel_batches,
    load_scenes,
    perturb_velocity,
    split_train_val_test,
)
from piml_tpu_torch.data.views import (  # noqa: F401
    ChanneledData,
    PointwiseData,
    TimeIndexedData,
    make_time_indexed,
    merge_pointwise,
    neighbor_config,
    pad_agents,
    slice_frames,
    to_channeled,
    to_pointwise,
    window_slice,
)
from piml_tpu_torch.data import processing  # noqa: F401
