"""Config system: YAML files with UPPERCASE keys + overrides."""

from defensegan_torch.configs.config import Config, load_config, save_config

__all__ = ["Config", "load_config", "save_config"]
