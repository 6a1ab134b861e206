from .chart import CoordinateChart
from .charted_field import (
    RefinementField,
    coarse_windows,
    refinement_matrices,
)
from .healpix_field import HEALPixChart, RefinementHPField
