"""Config loading: the reference's YAML schema, verbatim-compatible
(counterpart of jepa_tpu/configs.py). ``load_config`` returns the plain
nested dict the apps read section by section; the extensions live under
existing sections with new keys (e.g. meta.mask_mode), so reference
configs run unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import yaml


def load_config(fname: str) -> Dict[str, Any]:
    with open(fname) as f:
        cfg = yaml.safe_load(f)
    return cfg


def dump_config(cfg: Dict[str, Any], path: str):
    with open(path, "w") as f:
        yaml.dump(cfg, f)
