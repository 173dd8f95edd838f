"""Symbolic regression of the learned messages (counterpart of
``piml_tpu/sr``): extraction on the model's device, fitting on the host."""

from piml_tpu_torch.sr.extract import (  # noqa: F401
    direction_filter,
    post_filter,
    prepare_symbolic_regression_data,
    prepare_symbolic_regression_data_polar,
    prepare_vector_regression_data,
)
from piml_tpu_torch.sr.fit import (  # noqa: F401
    ForceLawFit,
    HAVE_PYSR,
    VectorForceLawFit,
    fit_force_law,
    fit_force_law_mse,
    fit_vector_force_law,
    symbolic_regression,
)
from piml_tpu_torch.sr.gp import (  # noqa: F401
    Equation,
    GPSymbolicRegressor,
)
