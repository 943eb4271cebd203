"""JSON configuration bag (copy of ``ggpm_tpu/configs.py``; reference
configs/configs.py:4-35).

Same contract: load a flat JSON file into attributes, snapshot back with
``to_json``.  Unknown keys pass through untouched so reference config files
work as-is.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class Configs:
    def __init__(self, path: Optional[str] = None, args: Optional[dict] = None):
        self.args = args
        if path is not None:
            assert path.endswith('.json') and os.path.exists(path)
            with open(path) as f:
                self.from_json(json.load(f))
        elif args is not None:
            assert isinstance(args, dict)
            self.from_json(args)
        else:
            raise ValueError('Either path or args must be provided')

    def from_json(self, configs: dict) -> None:
        self.__dict__.update(configs)
        self.args = {k: v for k, v in self.__dict__.items() if k != 'args'}
        if getattr(self, 'atom_vocab_', 'missing') is None:
            from .graph.vocab import common_atom_vocab
            self.atom_vocab = common_atom_vocab
        save_dir = getattr(self, 'save_dir', None)
        if save_dir and not os.path.exists(save_dir):
            os.makedirs(save_dir, exist_ok=True)

    def to_json(self, path: str) -> None:
        assert isinstance(path, str) and path.endswith('.json')
        serializable = {k: v for k, v in self.args.items()
                        if isinstance(v, (int, float, str, bool, list, dict, type(None)))}
        with open(path, 'w') as f:
            json.dump(serializable, f, indent=2)

    def get(self, key, default=None):
        return getattr(self, key, default)
