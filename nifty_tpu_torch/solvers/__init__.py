from . import cg
from .cg import CGResults, static_cg
from .newton_cg import OptimizeResults, _newton_cg, minimize, newton_cg
