from .config import PARAMETERS, Config, require

__all__ = ["PARAMETERS", "Config", "require"]
