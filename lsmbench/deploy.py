"""A configuration's deployment of the program: one in-memory
``LSMGraph`` built from the configuration's ``store`` entry."""
from __future__ import annotations

from typing import List


class Deployment:
    def __init__(self, store_spec: dict, device, **config_overrides):
        from repro_torch.core import LSMGraph, StoreConfig
        if store_spec["kind"] != "single":
            raise ValueError(f"unknown store kind {store_spec['kind']!r}")
        params = dict(store_spec["config"])
        params.update(config_overrides)
        self.cfg = StoreConfig(**params)
        self.store = LSMGraph(self.cfg, device=device)
        self.shards: List = [self.store]

    def close(self) -> None:
        """The store's tensors go with the last reference to it."""
        self.store.close()
