from .lanczos import (
    lanczos_tridiag,
    stochastic_logdet_from_lanczos,
    stochastic_lq_logdet,
    stochastic_lq_tridiags,
)
from .unique import amend_unique, unique
