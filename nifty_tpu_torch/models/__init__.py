from .correlated_field import (
    CorrelatedField,
    CorrelatedFieldMaker,
    NonParametricAmplitude,
    make_grid,
    non_parametric_amplitude,
)
from .gauss_markov import IntegratedWienerProcess, integrated_wiener_process
