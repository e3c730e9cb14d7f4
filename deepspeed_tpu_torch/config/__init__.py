"""Config system: the inference and training blocks (ported) of the JAX
package's DeepSpeedConfig."""

from .config import DeepSpeedConfig, DeepSpeedConfigError
from .config_utils import load_config_json, loads_config_json

__all__ = [
    "DeepSpeedConfig",
    "DeepSpeedConfigError",
    "load_config_json",
    "loads_config_json",
]
