from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .zero_inference import ZeroInferenceEngine  # noqa: F401
