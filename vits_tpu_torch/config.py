"""Config loading: recursive attribute-dict HParams over a JSON config (own
copy of vits_tpu/config.py's HParams, get_hparams_from_file and
default_config_path)."""

from __future__ import annotations

import json
import os


class HParams:
    """Recursive attribute dict over a JSON config."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        return setattr(self, key, value)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return self.__dict__.__repr__()


def get_hparams_from_file(config_path: str) -> HParams:
    with open(config_path, "r") as f:
        config = json.load(f)
    return HParams(**config)


def default_config_path(name: str = "base") -> str:
    """The repo's `configs/<name>.json`."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        f"{name}.json")
