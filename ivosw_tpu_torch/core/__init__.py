from ivosw_tpu_torch.core.config import Config, default_config, load_config

__all__ = ["Config", "load_config", "default_config"]
