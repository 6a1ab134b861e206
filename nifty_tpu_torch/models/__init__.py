from .correlated_field import (
    CorrelatedField,
    CorrelatedFieldMaker,
    MaternAmplitude,
    NonParametricAmplitude,
    SimpleCorrelatedField,
    adjust_variances,
    make_grid,
    make_spherical_grid,
    matern_amplitude,
    non_parametric_amplitude,
)
from .dynamics import (
    dynamic_lightcone_operator,
    dynamic_operator,
    light_cone_kernel,
)
from .gauss_markov import (
    GaussMarkovProcess,
    IntegratedWienerProcess,
    OrnsteinUhlenbeckProcess,
    WienerProcess,
    integrated_wiener_process,
    ornstein_uhlenbeck_process,
    wiener_process,
)
