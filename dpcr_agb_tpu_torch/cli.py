"""What the port's config-driven entry points share: the repository's
`conf/` tree, the `device=` override (taken off before composing, so the
config grammar never sees it) and the visualization groups."""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .config import yaml

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")


def split_device(overrides: List[str]) -> Tuple[Optional[str], List[str]]:
    """(the value of the last `device=`, or None; the other overrides)."""
    device = None
    rest = []
    for o in overrides:
        if o.startswith("device="):
            device = o.split("=", 1)[1]
        else:
            rest.append(o)
    return device, rest


def visualization_group(name: str) -> dict:
    """conf/visualization/<name>.yaml as a dict."""
    with open(os.path.join(CONF_DIR, "visualization", f"{name}.yaml")) as f:
        return yaml.safe_load(f.read())
