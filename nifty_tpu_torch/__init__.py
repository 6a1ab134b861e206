"""PyTorch port of nifty_tpu: geoVI on correlated fields, with hand-written
CUDA kernels for the power distributor.

The package mirrors ``nifty_tpu``'s layout and public names and imports
``torch``, ``numpy`` and ``scipy`` only, never ``jax``.
"""

from . import config
from .custom_map import lmap, smap, vmap
from .evi import (
    Samples,
    draw_linear_residual,
    draw_linear_residuals,
    draw_residual,
    nonlinearly_update_residual,
    nonlinearly_update_residuals,
    sample_likelihood,
)
from .likelihood import Likelihood, LikelihoodPartial, LikelihoodWithModel
from .likelihood_impl import Gaussian
from .logger import logger
from .minisanity import minisanity, reduced_residual_stats
from .model import Initializer, LazyModel, Model, WrappedCall
from .models import (
    CorrelatedFieldMaker,
    GaussMarkovProcess,
    IntegratedWienerProcess,
    OrnsteinUhlenbeckProcess,
    SimpleCorrelatedField,
    WienerProcess,
    adjust_variances,
    make_grid,
    matern_amplitude,
    non_parametric_amplitude,
)
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .probing import approximation2endo
from .prior import LogNormalPrior, NormalPrior
from .sample_io import load_samples, save_samples
from .solvers import minimize, static_cg, static_cg_batched
from .solvers.newton_cg import OptimizeResults
from .tree import (
    HostKey,
    ShapeWithDtype,
    Vector,
    from_numpy,
    mean_and_std,
    random_like,
    split,
    to_numpy,
)
