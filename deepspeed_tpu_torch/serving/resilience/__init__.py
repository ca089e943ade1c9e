from .errors import InvariantViolation, ServingStalledError  # noqa: F401
