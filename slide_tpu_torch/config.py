"""Experiment configs in the reference's JSON schema (counterpart:
`slide_tpu/config.py`, a copy).  The reference stores lists inside JSON as
their `str()`; `restore_lists` turns them back with `ast.literal_eval`, and
`write_json_file(reference_style=True)` writes them that way.

Top-level sections: diffusion_config | standard_diffusion_config,
pointnet_config, train_config, shapenet_psr_dataset_config, dist_config,
dpsr_config, autoencoder_config."""

from __future__ import annotations

import ast
import copy
import json
import os
import re
from typing import Any


def _restore(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _restore(v) for k, v in node.items()}
    if isinstance(node, str):
        try:
            v = ast.literal_eval(node)
        except (ValueError, SyntaxError):
            return node
        return v if isinstance(v, list) else node
    return node


def restore_lists(config: dict) -> dict:
    """Recursively convert stringified lists back to lists."""
    return _restore(config)


def stringify_lists(config: dict) -> dict:
    """The reference's on-disk form: every list (at any depth of dicts) as
    its `str()`."""
    out = {}
    for k, v in config.items():
        if isinstance(v, list):
            out[k] = str(v)
        elif isinstance(v, dict):
            out[k] = stringify_lists(v)
        else:
            out[k] = v
    return out


def read_json_file(path: str) -> dict:
    """A config file, its stringified lists restored."""
    with open(path) as f:
        config = json.load(f)
    return restore_lists(config)


def write_json_file(path: str, config: dict, reference_style: bool = False):
    """Write `config` as indented JSON; `reference_style` stringifies its
    lists first."""
    cfg = stringify_lists(copy.deepcopy(config)) if reference_style else config
    with open(path, "w") as f:
        json.dump(cfg, f, indent=4)


def find_config_file(file_name: str) -> str:
    """Given a config path or a directory, the config json: the named file
    where it exists, else the `*config*.json` beside it (or in the
    directory) with the largest number in its name."""
    if "config" in file_name and file_name.endswith(".json"):
        if os.path.isfile(file_name):
            return file_name
        file_path = os.path.split(file_name)[0]
    elif os.path.isdir(file_name):
        file_path = file_name
    else:
        raise FileNotFoundError(file_name)
    files = [f for f in os.listdir(file_path) if "config" in f and f.endswith(".json")]
    if not files:
        raise FileNotFoundError(f"no config json under {file_path}")
    best, best_num = files[0], -1
    for f in files:
        nums = [int(n) for n in re.findall(r"\d+", f)]
        num = max(nums) if nums else -1
        if num > best_num:
            best, best_num = f, num
    return os.path.join(file_path, best)


def autoencoder_read_config(config_dir: str, config: dict):
    """(encoder pointnet_config, [decoder pointnet_config, ...]): the main
    config names an encoder config file and a list of decoder config files
    under `config_dir`."""
    pc = config["pointnet_config"]
    encoder = read_json_file(os.path.join(config_dir, pc["encoder_config_file"]))
    decoders = [read_json_file(os.path.join(config_dir, f))
                for f in pc["decoder_config_file"]]
    return encoder["pointnet_config"], [d["pointnet_config"] for d in decoders]
