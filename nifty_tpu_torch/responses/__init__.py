from .los import SamplingCartesianGridLOS
from .ski import (
    HarmonicSKI,
    StructuredKernelInterpolation,
    ToeplitzSKI,
    interpolation_matrix,
    matmul_bttb,
    matmul_toeplitz,
)
