"""Synthetic crowds: the scenario library, the social-force generator and
the MLAPM simulator (counterpart of ``piml_tpu/gen``)."""

from piml_tpu_torch.gen.route import route  # noqa: F401
from piml_tpu_torch.gen.scenarios import SCENARIOS  # noqa: F401
from piml_tpu_torch.gen.socialforce import (  # noqa: F401
    SFParams,
    SpawnSchedule,
    simulate,
    social_force,
    to_scene,
)
from piml_tpu_torch.gen.mlapm_sim import (  # noqa: F401
    circle_demo,
    regenerate_scenario_npy,
    simulate_mlapm,
)
