from .runner import RunResult, run_sequence  # noqa: F401
from .vo import VisualOdometry  # noqa: F401
