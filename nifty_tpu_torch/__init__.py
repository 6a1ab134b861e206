"""PyTorch port of nifty_tpu: geoVI on correlated fields (Fourier subgrids
and the sphere), iterative charted refinement, line-of-sight tomography,
structured kernel interpolation, HMC/NUTS, Wiener filtering, parametric
VI, the evidence lower bound (ARPACK or stochastic Lanczos quadrature),
dynamics priors, radio interferometry (the NUFFT and a w-stacked
response), the first-order and trust-region minimizers, the INI-file
driver, instrumentation, plots and HDF5/FITS export, with
hand-written CUDA kernels for the power distributor, the refinement step,
the HEALPix longitude stage, the ray integral and the NUFFT window.

The package mirrors ``nifty_tpu``'s layout and public names and imports
``torch``, ``numpy`` and ``scipy`` only, never ``jax``.
"""

from . import config
from . import domains, num
from .config_driver import OptimizeKLConfig
from .custom_map import lmap, smap, vmap
from .domains import (
    DOFSpace,
    Domain,
    DomainTuple,
    GLSpace,
    HPSpace,
    LMSpace,
    PowerSpace,
    RGSpace,
    UnstructuredDomain,
)
from .evidence_lower_bound import estimate_evidence_lower_bound
from .evi import (
    Samples,
    draw_linear_residual,
    draw_linear_residuals,
    draw_residual,
    nonlinearly_update_residual,
    nonlinearly_update_residuals,
    sample_likelihood,
)
from .extra import (
    assert_equal_tree,
    check_dtype_purity,
    check_inverse,
    check_likelihood,
    check_linear_model,
    check_model,
    check_purity,
)
from .likelihood import (
    Likelihood,
    LikelihoodPartial,
    LikelihoodSum,
    LikelihoodWithModel,
)
from .likelihood_impl import (
    Bernoulli,
    Categorical,
    Gaussian,
    InverseGamma,
    Poissonian,
    StudentT,
    VariableCovarianceGaussian,
    VariableCovarianceStudentT,
)
from .hmc import generate_hmc_acc_rej, generate_nuts_tree
from .hmc_oo import Chain, HMCChain, NUTSChain
from .field import (
    Field,
    create_power_operator,
    dof_distributor,
    from_random,
    full,
    makeField,
    power_analyze,
)
from .instrumentation import CountingModel, exec_time
from .logger import logger
from .minisanity import minisanity, reduced_residual_stats
from .misc import hvp, interpolate
from .model import Initializer, LazyModel, Model, WrappedCall, wrap, wrap_left
from .models import (
    CorrelatedFieldMaker,
    GaussMarkovProcess,
    IntegratedWienerProcess,
    OrnsteinUhlenbeckProcess,
    SimpleCorrelatedField,
    WienerProcess,
    adjust_variances,
    dynamic_lightcone_operator,
    dynamic_operator,
    make_grid,
    matern_amplitude,
    non_parametric_amplitude,
)
from .ops.healpix_sht import HEALPixSHT
from .ops.sht import SphericalHarmonicTransform, SphericalHarmonicTransformOnTheFly
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .plot import Plot
from .pytree_string import PyTreeString, hide_strings, unhide_strings
from .probing import (
    StatCalculator,
    approximation2endo,
    operator_spectrum,
    probe_diagonal,
    probe_trace,
)
from .refine import (
    CoordinateChart,
    HEALPixChart,
    RefinementField,
    RefinementHPField,
    coarse_windows,
    refinement_matrices,
)
from .responses import (
    HarmonicSKI,
    SamplingCartesianGridLOS,
    StructuredKernelInterpolation,
    ToeplitzSKI,
    interpolation_matrix,
    matmul_bttb,
    matmul_toeplitz,
)
from .prior import (
    GammaPrior,
    InvGammaPrior,
    LaplacePrior,
    LogInvGammaPrior,
    LogNormalPrior,
    NormalPrior,
    UniformPrior,
)
from .sample_io import (
    load_checkpoint_orbax,
    load_samples,
    read_fits,
    save_checkpoint_orbax,
    save_samples,
    save_samples_to_fits,
    save_samples_to_hdf5,
    write_fits,
)
from .solvers.cg import cg
from .solvers import (
    OptimizeResults,
    lbfgs,
    minimize,
    minimize_scipy,
    newton_cg,
    nonlinear_cg,
    static_cg,
    static_cg_batched,
    steepest_descent,
    trust_ncg,
    vlbfgs,
)
from .stats import (
    gamma_prior,
    interpolator,
    invgamma_invprior,
    invgamma_prior,
    laplace_prior,
    log_invgamma_prior,
    lognormal_invprior,
    lognormal_moments,
    lognormal_prior,
    normal_invprior,
    normal_prior,
    uniform_prior,
)
from .sugar import calculate_position, density_estimator
from .variational import FullCovarianceVI, MeanFieldVI
from .wiener_filter import (
    draw_posterior_sample,
    wiener_filter,
    wiener_filter_curvature,
)
from .tree import (
    HostKey,
    ShapeWithDtype,
    Vector,
    dot,
    from_numpy,
    get_map,
    mean,
    mean_and_std,
    norm,
    random_like,
    split,
    stack,
    to_numpy,
    unite,
    unstack,
    vdot,
    zeros_like,
)

__version__ = "0.1.0"
