from . import cg
from .cg import CGResults, static_cg, static_cg_batched
from .newton_cg import (
    OptimizeResults,
    _newton_cg,
    _newton_cg_batched,
    batched_form,
    minimize,
    minimize_batched,
    newton_cg,
)
from .descent import _nonlinear_cg, _steepest_descent, nonlinear_cg, steepest_descent
from .lbfgs import _lbfgs, lbfgs
from .scipy_bridge import minimize_scipy
from .trust_ncg import _trust_ncg, cg_steihaug_subproblem, trust_ncg
from .vlbfgs import _vlbfgs, vlbfgs
