"""PyTorch port of nifty_tpu: geoVI on correlated fields, with hand-written
CUDA kernels for the power distributor.

The package mirrors ``nifty_tpu``'s layout and public names and imports
``torch``, ``numpy`` and ``scipy`` only, never ``jax``.
"""

from . import config
from .custom_map import lmap, smap
from .evi import (
    Samples,
    draw_linear_residual,
    nonlinearly_update_residual,
    sample_likelihood,
)
from .likelihood import Likelihood, LikelihoodWithModel
from .likelihood_impl import Gaussian
from .logger import logger
from .model import Initializer, LazyModel, Model, WrappedCall
from .models.correlated_field import CorrelatedFieldMaker, make_grid
from .models.gauss_markov import IntegratedWienerProcess
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .prior import LogNormalPrior, NormalPrior
from .solvers import minimize, static_cg
from .solvers.newton_cg import OptimizeResults
from .tree import (
    HostKey,
    ShapeWithDtype,
    Vector,
    from_numpy,
    random_like,
    split,
    to_numpy,
)
