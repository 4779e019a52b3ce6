"""Tiered entity store (port of photon_ml_tpu/store/): one residency layer
for training and for serving entity tables past the device budget.

  * `TieredEntityStore` (store/entity.py) — a row table spanning a
    device-resident hot set (a torch tensor on the store's device, replaced
    out of place by every promotion or write-through, sampled LFU), a host
    warm set (authoritative row values, write-back dirty tracking), and
    durable sealed cold segments (store/cold.py, byte-compatible with the
    JAX package's).  Tenants: the serving scorer, delta swaps and audit
    readers.
  * `BlockStore` / `BlockHandle` (store/handles.py) — the block handles
    game/residency.py rotates training residency through, and
    `ResidencyRegistry`, the keyed registry the mesh staging layer
    (parallel/mesh_residency.py) keeps its entries in.
  * `with_retries` / `StoreStats` / `StoreError` (store/base.py) — the
    shared transient/fatal retry discipline and tier accounting; fault
    sites `store.fetch` / `store.promote` / `store.spill`.
"""
from photon_ml_tpu_torch.store.base import (StoreError, StoreStats,  # noqa: F401
                                            with_retries)
from photon_ml_tpu_torch.store.cold import ColdStore, ColdStoreError  # noqa: F401
from photon_ml_tpu_torch.store.entity import (StoreConfig,  # noqa: F401
                                              TieredEntityStore, store_totals)
from photon_ml_tpu_torch.store.handles import (BlockHandle, BlockStore,  # noqa: F401
                                               ResidencyRegistry)

__all__ = [
    "BlockHandle", "BlockStore", "ColdStore", "ColdStoreError",
    "ResidencyRegistry", "StoreConfig",
    "StoreError", "StoreStats", "TieredEntityStore", "store_totals",
    "with_retries",
]
