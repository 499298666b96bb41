from .core import System, SimState, StepStats  # noqa: F401
from .dot import DOTStepper  # noqa: F401
from .newton import NewtonStepper  # noqa: F401
from .lbfgs import LBFGSPD, LBFGSH, LBFGSHI, LBFGSJH  # noqa: F401
from .gsdd import GSDDStepper  # noqa: F401
