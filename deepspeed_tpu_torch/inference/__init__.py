from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
