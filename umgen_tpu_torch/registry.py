"""Component registry: string → builder indirection.

Equivalent of the reference's mmcv Registry pair (ref:projects/registry.py,
`MODELS`/`DATASETS` + build_from_cfg): lets configs name components by
string so downstream code stays decoupled from concrete classes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *,
                 name: Optional[str] = None):
        def deco(o):
            key = name or o.__name__
            if key in self._items:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._items[key] = o
            return o

        return deco(obj) if obj is not None else deco

    def get(self, name: str) -> Callable:
        if name not in self._items:
            raise KeyError(f"{name!r} not in registry {self.name}; "
                           f"known: {sorted(self._items)}")
        return self._items[name]

    def build(self, cfg: Dict[str, Any]):
        """build_from_cfg semantics: {'type': name-or-callable, **kwargs}."""
        cfg = dict(cfg)
        t = cfg.pop("type")
        fn = t if callable(t) else self.get(t)
        return fn(**cfg)

    def __contains__(self, name: str) -> bool:
        return name in self._items


MODELS = Registry("model")
DATASETS = Registry("dataset")


def register_builtins():
    """Register the framework's own components (idempotent)."""
    from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
    from umgen_tpu_torch.models.umgen import UMGen
    if "UMGen" not in MODELS:
        MODELS.register(UMGen)
    if "NuPlanTokenDataset" not in DATASETS:
        DATASETS.register(NuPlanTokenDataset)
