from .bin_gather import (
    BinGather,
    BinIndex,
    BinSegmentSum,
    distribute_power,
    segment_sum,
    sorted_scatter_aux,
)
from .harmonic import hartley
