"""Config composition of the port: the YAML subset reader and the
Hydra-compatible engine over the repository's `conf/` tree."""
from .engine import (Cfg, MISSING, MissingMandatoryValue,
                     compose_from_checkpoint, load_config, parse_overrides)

__all__ = ["Cfg", "MISSING", "MissingMandatoryValue", "compose_from_checkpoint",
           "load_config", "parse_overrides"]
