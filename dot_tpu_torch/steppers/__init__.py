from .core import System, SimState, StepStats  # noqa: F401
from .dot import DOTStepper  # noqa: F401
