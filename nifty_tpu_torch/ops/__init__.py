from .bin_gather import (
    BinGather,
    BinIndex,
    BinSegmentSum,
    distribute_power,
    segment_sum,
    sorted_scatter_aux,
)
from .harmonic import hartley
from .healpix_sht import HEALPixSHT
from .hp_longitude import HpLongitude, HpLongitudeAdjoint, HPRings
from .los_interp import LosIntegrate, LosIntegrateAdjoint, LosTable
from .nufft import RadioResponse, nufft1, nufft2, nufft_window_aux
from .nufft_window import WindowInterp, WindowSpread, WindowTable
from .icr_refine import IcrRefine, IcrRefineTranspose, RefineLevel, refine_level
from .sht import SphericalHarmonicTransform, SphericalHarmonicTransformOnTheFly
