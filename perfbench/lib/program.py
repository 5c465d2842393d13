"""The system under test as users set it up: the port's configuration
object from a configuration file's ``port`` section, and its parameter tree
filled with the benchmark's weights.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict

import torch


def model_config(port: dict):
    """``repro_torch.models.config.ModelConfig`` from a dict of its fields;
    a nested dict becomes the dataclass its field names (``moe``, ``ssm``)."""
    from repro_torch.models import config as cfg_mod

    hints = typing.get_type_hints(cfg_mod.ModelConfig, vars(cfg_mod))
    kw = {}
    for k, v in port.items():
        if isinstance(v, dict):
            cls = next(a for a in typing.get_args(hints[k]) if dataclasses.is_dataclass(a))
            v = cls(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cfg_mod.ModelConfig(**kw)


def param_tree(cfg, flat: Dict[str, torch.Tensor]):
    """The program's parameter tree holding ``flat``'s leaves; raises where a
    path or a shape differs from the program's own parameter layout."""
    from repro_torch.models import param_shapes
    from repro_torch.models.params import flatten_params, tree_like

    want = {p: s.shape for p, s in flatten_params(param_shapes(cfg)).items()}
    got = {p: tuple(t.shape) for p, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"{cfg.name}: weights differ from the program's layout: {diff[:6]}")
    return tree_like(param_shapes(cfg), flat)
