"""Dataset -> device-block builders: the shuffle work, done once at prep time
(port of photon_ml_tpu/data/batching.py).

Grouping by entity, the per-entity reservoir cap with weight rescaling,
passive data, Pearson feature selection and the index-map projection run
once on host numpy, exactly as in the JAX package (the same numpy calls, so
the same blocks bit for bit, sampling included: numpy's
`default_rng(config.seed)`); the finished [E, S, d] blocks go to the
device once.  The training loop touches only tensors after this point.

The `random_projection:<k>` projector's Gaussian matrix is the JAX
package's draw, from utils/prng.py's copy of its PRNG (drawn in the blocks'
dtype, as the JAX package draws in its default float).

Device residency: a bucket's `blocks` is a lazily made device copy.  The
resident build makes it at once and keeps no host copy; with
`keep_host_blocks` (an HBM budget, game/residency.py) the numpy blocks stay
in `host_blocks`, `evict()` drops the device copy between coordinate-
descent visits and the next `blocks` access copies it again.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.parallel.random_effect import (
    EntityBlocks, scatter_local_to_global,
)
from photon_ml_tpu_torch.utils.math import ceil_pow2 as _ceil_pow2

_SAFE_LABEL = 0.5  # valid for every loss family


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfig:
    """reference: FixedEffectDataConfiguration.scala (featureShardId)."""

    feature_shard: str


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """reference: RandomEffectDataConfiguration.scala:42-140.
    `active_data_upper_bound` caps per-entity samples (reservoir-style, with
    weight rescaling); rows beyond the cap become passive data (scored, not
    trained on) when the entity has more than `passive_data_lower_bound`
    leftover rows.  `features_to_samples_ratio` triggers per-entity Pearson
    feature selection.  `projector` in {"index_map", "identity"}."""

    random_effect_type: str
    feature_shard: str
    active_data_upper_bound: Optional[int] = None
    passive_data_lower_bound: Optional[int] = None
    features_to_samples_ratio: Optional[float] = None
    # "index_map" | "identity" | "random_projection:<k>"
    projector: str = "index_map"
    seed: int = 7
    # cap on the number of S-buckets (None = one bucket per power-of-two
    # sample-count class)
    max_buckets: Optional[int] = 4
    # keep the host numpy blocks beside the device copies, so the residency
    # manager can EVICT the device blocks between coordinate-descent visits
    # and copy them again from the host (out-of-core mode)
    keep_host_blocks: bool = False


@dataclasses.dataclass
class FixedEffectDataset:
    """Flat [n] arrays for one shard, canonical row order."""

    x: np.ndarray
    labels: np.ndarray
    weights: Optional[np.ndarray]
    offsets: Optional[np.ndarray]
    feature_shard: str

    @staticmethod
    def build(dataset: GameDataset, config: FixedEffectDataConfig) -> "FixedEffectDataset":
        return FixedEffectDataset(
            x=dataset.feature_shards[config.feature_shard],
            labels=dataset.response,
            weights=dataset.weights,
            offsets=dataset.offsets,
            feature_shard=config.feature_shard)


def _blocks_on(host: EntityBlocks, device, dtype: torch.dtype) -> EntityBlocks:
    on = lambda a: None if a is None else torch.as_tensor(a).to(device=device, dtype=dtype)
    return EntityBlocks(x=on(host.x), labels=on(host.labels), mask=on(host.mask),
                        weights=on(host.weights), offsets=on(host.offsets))


@dataclasses.dataclass
class EntityBucket:
    """One size class of entities: lanes [lane_start, lane_start + Eb) of
    the dataset's count-descending lane order, padded to this bucket's own
    S (one hot entity must not pad every block).

    `blocks` is the device copy on `device` in `dtype`, made on first
    access; with `host_blocks` (the numpy blocks, kept under an HBM budget)
    `evict()` drops it and the next access copies it again."""

    lane_start: int
    row_ids: np.ndarray             # [Eb, Sb] canonical row ids, -1 = pad
    device: torch.device
    dtype: torch.dtype
    host_blocks: Optional[EntityBlocks] = None   # numpy leaves (re-stage source)
    _blocks: Optional[EntityBlocks] = dataclasses.field(
        default=None, repr=False, compare=False)
    _safe_ids_dev: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_entities(self) -> int:
        return self.row_ids.shape[0]

    @property
    def samples_per_entity(self) -> int:
        return self.row_ids.shape[1]

    @property
    def dim(self) -> int:
        src = self._blocks if self._blocks is not None else self.host_blocks
        return src.x.shape[2]

    @property
    def block_dtype(self) -> torch.dtype:
        return self.dtype

    @property
    def blocks(self) -> EntityBlocks:
        """Device EntityBlocks, copied on first access (or again after an
        evict())."""
        if self._blocks is None:
            if self.host_blocks is None:
                raise ValueError("bucket was built without host blocks and "
                                 "its device copy is gone; rebuild the "
                                 "random-effect dataset")
            self._blocks = _blocks_on(self.host_blocks, self.device, self.dtype)
        return self._blocks

    @property
    def is_resident(self) -> bool:
        return self._blocks is not None

    def evict(self) -> None:
        """Drop the device copy (needs host_blocks to copy it again)."""
        if self.host_blocks is None:
            return  # nothing to copy again from: keep the device copy
        self._blocks = None
        self._safe_ids_dev = None

    def device_bytes(self) -> int:
        """Bytes this bucket holds (or would hold) on the device."""
        src = self._blocks if self._blocks is not None else self.host_blocks
        if src is None:
            return 0
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return sum(int(np.prod(leaf.shape)) * itemsize
                   for leaf in (src.x, src.labels, src.mask, src.weights, src.offsets)
                   if leaf is not None)

    def safe_ids_dev(self) -> torch.Tensor:
        """Device copy of the clamped row ids, transferred once."""
        if self._safe_ids_dev is None:
            self._safe_ids_dev = torch.as_tensor(
                np.maximum(self.row_ids, 0), device=self.device)
        return self._safe_ids_dev

    def with_offsets_from_flat(self, flat_offsets: torch.Tensor) -> EntityBlocks:
        """addScoresToOffsets: gather the canonical-order offsets into this
        bucket's [Eb, Sb] layout (padding cells 0)."""
        b = self.blocks
        off = (flat_offsets[self.safe_ids_dev()] * b.mask).to(b.x.dtype)
        return b.with_offsets(off)


@dataclasses.dataclass
class RandomEffectDataset:
    """Per-entity training blocks + the index plumbing to score flat rows:
      - entity_position[v]: vocab entity v -> block lane (-1 if unseen)
      - bucket row_ids[e, s]: block cell -> canonical row id (-1 pad), which
        also realizes addScoresToOffsets as one gather.
    Entities live in count-descending lane order, partitioned into
    S-buckets; `blocks` / `active_row_ids` are single-S views padded to the
    global max, built lazily."""

    config: RandomEffectDataConfig
    buckets: list  # List[EntityBucket], contiguous lanes, ascending start
    entity_ids: np.ndarray          # [E] vocab indices, block lane order
    entity_position: np.ndarray     # [V] vocab index -> block lane or -1
    projection: Optional[np.ndarray]  # [E, d_local] global col ids, -1 pad
    global_dim: int
    num_active: int
    num_passive: int
    # canonical rows capped out of entities whose leftover count is at or
    # below passive_data_lower_bound: discarded, not scored (lane -1)
    discarded_rows: Optional[np.ndarray] = None
    # dense shared Gaussian projection [k + 1, d_global] of the
    # random_projection:<k> projector (exclusive with `projection`)
    projection_matrix: Optional[np.ndarray] = None
    _global_blocks: Optional[EntityBlocks] = dataclasses.field(
        default=None, repr=False, compare=False)
    _global_row_ids: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    _safe_ids_dev: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def local_dim(self) -> int:
        return self.buckets[0].dim

    @property
    def dtype(self) -> torch.dtype:
        return self.buckets[0].block_dtype

    @property
    def max_samples(self) -> int:
        return max(b.samples_per_entity for b in self.buckets)

    def padding_stats(self) -> Dict[str, float]:
        """Fraction of block cells holding real rows, bucketed vs the
        single-S layout it replaces."""
        cells = sum(b.num_entities * b.samples_per_entity for b in self.buckets)
        single = self.num_entities * self.max_samples
        return {"num_buckets": len(self.buckets),
                "bucketed_efficiency": self.num_active / max(cells, 1),
                "single_block_efficiency": self.num_active / max(single, 1)}

    @property
    def active_row_ids(self) -> np.ndarray:
        """[E, S_max] single-S view (lazily materialized)."""
        if self._global_row_ids is None:
            S = self.max_samples
            parts = [np.pad(b.row_ids, ((0, 0), (0, S - b.row_ids.shape[1])),
                            constant_values=-1) for b in self.buckets]
            self._global_row_ids = np.concatenate(parts, axis=0)
        return self._global_row_ids

    @property
    def blocks(self) -> EntityBlocks:
        """Single-S EntityBlocks view over all lanes (lazily materialized)."""
        if self._global_blocks is None:
            S = self.max_samples

            def cat(get, fill):
                parts = [get(b.blocks) for b in self.buckets]
                if any(p is None for p in parts):
                    return None
                return torch.cat([
                    torch.nn.functional.pad(
                        p.movedim(1, -1), (0, S - p.shape[1]), value=fill
                    ).movedim(-1, 1) for p in parts], dim=0)
            self._global_blocks = EntityBlocks(
                x=cat(lambda b: b.x, 0.0), labels=cat(lambda b: b.labels, _SAFE_LABEL),
                mask=cat(lambda b: b.mask, 0.0), weights=cat(lambda b: b.weights, 0.0),
                offsets=cat(lambda b: b.offsets, 0.0))
        return self._global_blocks

    def with_offsets_from_flat(self, flat_offsets: torch.Tensor) -> EntityBlocks:
        """addScoresToOffsets on the single-S view (bucketed consumers use
        EntityBucket's)."""
        blocks = self.blocks
        if self._safe_ids_dev is None:
            self._safe_ids_dev = torch.as_tensor(
                np.maximum(self.active_row_ids, 0), device=blocks.x.device)
        off = (flat_offsets[self._safe_ids_dev] * blocks.mask).to(blocks.x.dtype)
        return blocks.with_offsets(off)

    def scatter_to_global(self, local_coefficients: torch.Tensor) -> torch.Tensor:
        """[E, d_local] local-space coefficients -> [E, d_global] (P^T c for
        the random projection)."""
        if self.projection_matrix is not None:
            return local_coefficients @ torch.as_tensor(
                self.projection_matrix, device=local_coefficients.device,
                dtype=local_coefficients.dtype)
        return scatter_local_to_global(local_coefficients, self.projection,
                                       self.global_dim)

    def evict_device_blocks(self) -> None:
        """Drop every device block copy (buckets + the single-S views).
        Buckets without a host copy (built without keep_host_blocks) keep
        theirs.  The next access copies them again: the residency
        manager's between-visits rotation (game/residency.py)."""
        for b in self.buckets:
            b.evict()
        self._global_blocks = None       # (_global_row_ids is host: kept)
        self._safe_ids_dev = None

    def device_bytes(self) -> int:
        """Device bytes of all bucket blocks (+ the single-S view when it
        has been made: the factored random effect holds both)."""
        total = sum(b.device_bytes() for b in self.buckets)
        g = self._global_blocks
        if g is not None:
            total += sum(int(leaf.nbytes) for leaf in
                         (g.x, g.labels, g.mask, g.weights, g.offsets)
                         if leaf is not None)
        return total

    def flat_entity_lanes(self, entity_index: np.ndarray) -> np.ndarray:
        """Map a canonical-order entity-index column to block lanes.
        Discarded rows (capped out of below-bound entities) get lane -1."""
        idx = np.asarray(entity_index)
        lanes = np.full_like(idx, -1)
        valid = idx >= 0
        lanes[valid] = self.entity_position[idx[valid]]
        if self.discarded_rows is not None and len(self.discarded_rows):
            lanes[self.discarded_rows] = -1
        return lanes


# (dataset -> {(config, host dtype, device, dtype) -> built blocks}) memo:
# refits of the same data under other lambdas reuse the blocks
_BUILD_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def build_random_effect_dataset(
    dataset: GameDataset,
    config: RandomEffectDataConfig,
    dtype=np.float64,
    *,
    device=None,
    block_dtype: torch.dtype = torch.float32,
) -> RandomEffectDataset:
    """Group-by-entity -> cap -> select features -> project -> pad, on the
    host in numpy `dtype`; the blocks go to `device` (None means cuda) in
    `block_dtype`.  Memoized per (dataset, config, dtypes, device).

    reference call path: RandomEffectDataSet.apply (scala:240-277) +
    featureSelectionOnActiveData (scala:457-471) +
    RandomEffectDataSetInProjectedSpace.buildWithProjectorType."""
    dev = resolve_device(device)
    per_ds = _BUILD_CACHE.setdefault(dataset, {})
    key = (config, np.dtype(dtype).name, str(dev), block_dtype)
    if key not in per_ds:
        per_ds[key] = _build_random_effect_dataset(dataset, config, dtype,
                                                   dev, block_dtype)
    return per_ds[key]


def _build_random_effect_dataset(
    dataset: GameDataset,
    config: RandomEffectDataConfig,
    dtype,
    device: torch.device,
    block_dtype: torch.dtype,
) -> RandomEffectDataset:
    """One lexsort replaces groupByKey, the per-entity reservoir cap is a
    segmented random-key rank cut, the index-map projector is segment
    reductions over the group-sorted rows, and entities are packed into
    power-of-two S-buckets in count-descending lane order."""
    if (config.projector not in ("index_map", "identity")
            and not config.projector.startswith("random_projection:")):
        raise ValueError(f"unknown projector {config.projector!r} (expected "
                         "'index_map', 'identity', or 'random_projection:<k>')")
    if not isinstance(dataset.feature_shards[config.feature_shard], np.ndarray):
        raise TypeError(
            f"random-effect shard {config.feature_shard!r} must be a dense "
            "array (sparse per-entity shards would gather ragged columns); "
            "project or densify it at ingest")
    re_type = config.random_effect_type
    x_flat = np.asarray(dataset.feature_shards[config.feature_shard], dtype=dtype)
    y_flat = np.asarray(dataset.response, dtype=dtype)
    w_flat = None if dataset.weights is None else np.asarray(dataset.weights, dtype)
    o_flat = None if dataset.offsets is None else np.asarray(dataset.offsets, dtype)
    ent = np.asarray(dataset.entity_indices[re_type])
    n, d_global = x_flat.shape
    rng = np.random.default_rng(config.seed)

    present = ent >= 0
    uniq = np.unique(ent[present])
    E = len(uniq)
    if E == 0:
        raise ValueError(f"no rows carry entity ids for {re_type!r}")

    # group rows per entity (one stable argsort — the groupByKey
    # replacement); within an entity, canonical row order is preserved
    uniq_rank_of = np.full(dataset.num_entities(re_type), -1, dtype=np.int64)
    uniq_rank_of[uniq] = np.arange(E)
    grp_all = uniq_rank_of[ent[present]]
    order = np.argsort(grp_all, kind="stable")
    rows_sorted = np.flatnonzero(present)[order]     # canonical ids, grouped
    grp = grp_all[order]                             # uniq-rank per sorted row
    counts = np.bincount(grp, minlength=E)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    # --- reservoir cap: segmented random-key rank cut --------------------
    cap = config.active_data_upper_bound
    weight_scale = np.ones(E)
    num_passive = 0
    discarded_rows = np.zeros((0,), dtype=np.int64)
    if cap is not None and (counts > cap).any():
        keys = rng.random(len(rows_sorted))
        rand_order = np.lexsort((keys, grp))
        rank_in_entity = np.arange(len(rows_sorted)) - np.repeat(starts, counts)
        keep = np.empty(len(rows_sorted), dtype=bool)
        # row rand_order[i] has within-entity random rank rank_in_entity[i]
        # because groups stay contiguous under lexsort
        keep[rand_order] = rank_in_entity < cap
        over = counts > cap
        # weight rescale so the capped sample represents the full count
        # (reference: MinHeapWithFixedCapacity, RandomEffectDataSet.scala:325-388)
        weight_scale[over] = counts[over] / cap
        leftover = counts - np.minimum(counts, cap)
        lower = config.passive_data_lower_bound
        # leftovers of entities above the passive lower bound are passive
        # (scored, not trained on); at/below the bound they are discarded
        passive_entities = (np.ones(E, dtype=bool) if lower is None
                            else leftover > lower)
        num_passive = int(leftover[passive_entities & over].sum())
        drop_mask = ~keep & ~passive_entities[grp]
        discarded_rows = rows_sorted[drop_mask]
        rows_sorted, grp = rows_sorted[keep], grp[keep]
        counts = np.bincount(grp, minlength=E)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    # --- lane order: count-descending, then pow2 S-buckets ---------------
    perm = np.argsort(-counts, kind="stable")        # lane -> uniq rank
    lane_of = np.empty(E, dtype=np.int64)
    lane_of[perm] = np.arange(E)                     # uniq rank -> lane
    counts_lane = counts[perm]
    entity_ids = uniq[perm]
    entity_position = np.full(dataset.num_entities(re_type), -1, dtype=np.int64)
    entity_position[entity_ids] = np.arange(E)

    pow2_lane = _ceil_pow2(counts_lane)
    # group adjacent power-of-two classes when there are more classes than
    # max_buckets
    uniq_keys, key_of_lane = np.unique(pow2_lane, return_inverse=True)
    n_classes = len(uniq_keys)
    mb = config.max_buckets
    if mb is not None and n_classes > mb > 0:
        width = -(-n_classes // mb)
        key_of_lane = ((n_classes - 1) - key_of_lane) // width
    bucket_bounds = np.concatenate(
        [[0], np.flatnonzero(np.diff(key_of_lane)) + 1, [E]])

    # kept rows in (lane, canonical-row) order; per-lane slot index
    lane_rows = lane_of[grp]
    ord_lane = np.lexsort((rows_sorted, lane_rows))
    row_ids_l = rows_sorted[ord_lane]
    lane_l = lane_rows[ord_lane]
    lane_starts = np.concatenate([[0], np.cumsum(counts_lane)[:-1]])
    slot_l = np.arange(len(row_ids_l)) - np.repeat(lane_starts, counts_lane)

    # --- per-entity feature projection (index-map projector) --------------
    projection = None
    if config.projector == "index_map":
        # observed-column mask per entity: segmented any over kept rows
        # (every entity keeps >= 1 row, so no reduceat segment is empty)
        ind = (x_flat[rows_sorted] != 0)
        obs = np.logical_or.reduceat(ind, starts)
        ratio = config.features_to_samples_ratio
        intercept_col = d_global - 1  # intercept-last convention
        selected = obs
        if ratio is not None:
            selected = _pearson_select_segmented(
                x_flat, y_flat, rows_sorted, starts, counts, obs, ratio,
                intercept_col, w_flat)
        # ragged column lists -> [E, d_local] padded index array, columns
        # ascending per entity
        sel_lane = selected[perm]
        e_idx, col_idx = np.nonzero(sel_lane)
        per_entity = np.bincount(e_idx, minlength=E)
        d_local = int(per_entity.max()) if len(e_idx) else 1
        pos = np.arange(len(col_idx)) - np.repeat(
            np.concatenate([[0], np.cumsum(per_entity)[:-1]]), per_entity)
        projection = np.full((E, max(d_local, 1)), -1, dtype=np.int64)
        projection[e_idx, pos] = col_idx
    proj_matrix = None
    if config.projector.startswith("random_projection:"):
        # Gaussian random projection shared across entities (reference:
        # ProjectionMatrix.buildGaussianRandomProjectionMatrix); the
        # intercept column survives through the extra selector row.  As the
        # JAX package: drawn in the compute dtype, rounded to float32, then
        # held in the host dtype
        from photon_ml_tpu_torch.parallel.factored import gaussian_projection_matrix
        k = int(config.projector.split(":", 1)[1])
        proj_matrix = gaussian_projection_matrix(
            k, d_global, keep_intercept=True, seed=config.seed, dtype=torch.float32,
            draw_dtype=block_dtype, device="cpu").numpy().astype(dtype)

    # --- assemble buckets -------------------------------------------------
    # pad-row/pad-column trick: one zero row (and, for the index-map
    # projector, one zero column) appended to the flat arrays lets padding
    # ids gather zeros directly
    buckets = []
    num_active = len(row_ids_l)
    in_bucket_of_lane = np.searchsorted(bucket_bounds, lane_l, side="right") - 1
    d_pad = d_global + (1 if projection is not None else 0)
    x_pad = np.zeros((n + 1, d_pad), x_flat.dtype)
    x_pad[:n, :d_global] = x_flat
    y_pad = np.concatenate([y_flat, [_SAFE_LABEL]]).astype(dtype)
    w_pad = (None if w_flat is None
             else np.concatenate([w_flat, [0.0]]).astype(dtype))
    o_pad = (None if o_flat is None
             else np.concatenate([o_flat, [0.0]]).astype(dtype))
    for b in range(len(bucket_bounds) - 1):
        lb, ub = int(bucket_bounds[b]), int(bucket_bounds[b + 1])
        Eb = ub - lb
        Sb = int(counts_lane[lb:ub].max()) if Eb else 1
        sel = in_bucket_of_lane == b
        r_ids = np.full((Eb, max(Sb, 1)), -1, dtype=np.int64)
        r_ids[lane_l[sel] - lb, slot_l[sel]] = row_ids_l[sel]
        mask = (r_ids >= 0).astype(dtype)
        gat = np.where(r_ids >= 0, r_ids, n)  # pad cell -> zero row

        if projection is not None:
            cols = projection[lb:ub]
            gcols = np.where(cols >= 0, cols, x_flat.shape[1])  # -> zero col
            xb = x_pad[gat[:, :, None], gcols[:, None, :]]
        elif proj_matrix is not None:
            xb = np.einsum("esd,kd->esk", x_pad[gat], proj_matrix)
        else:
            xb = x_pad[gat]

        labels = y_pad[gat]
        # both the mask and gathered weights are already 0 at padding cells
        weights = ((w_pad[gat] if w_pad is not None else mask)
                   * weight_scale[perm[lb:ub], None])
        offsets = None if o_pad is None else o_pad[gat]
        host = EntityBlocks(x=xb, labels=labels, mask=mask, weights=weights,
                            offsets=offsets)
        bucket = EntityBucket(lane_start=lb, row_ids=r_ids, device=device,
                              dtype=block_dtype)
        if config.keep_host_blocks:
            # out-of-core build: the numpy blocks are the source; device
            # copies are made lazily and can be evicted
            bucket.host_blocks = host
        else:
            # resident build: copy at once and let the numpy blocks go
            bucket._blocks = _blocks_on(host, device, block_dtype)
        buckets.append(bucket)

    return RandomEffectDataset(
        config=config, buckets=buckets, entity_ids=entity_ids,
        entity_position=entity_position,
        projection=projection, global_dim=d_global,
        num_active=num_active, num_passive=num_passive,
        discarded_rows=discarded_rows, projection_matrix=proj_matrix)


def _pearson_select_segmented(
    x_flat: np.ndarray,
    y_flat: np.ndarray,
    rows_sorted: np.ndarray,
    starts: np.ndarray,
    counts: np.ndarray,
    obs: np.ndarray,
    ratio: float,
    intercept_col: int,
    w_flat: Optional[np.ndarray],
) -> np.ndarray:
    """Per-entity Pearson feature selection, all entities at once.

    For entities whose observed-column count exceeds ratio * num_samples,
    keep the ceil(ratio * num_samples) columns with the largest |corr(x, y)|
    (the intercept always survives).  reference: LocalDataSet
    .filterFeaturesByPearsonCorrelationScore (scala:135, 221-288)."""
    del w_flat  # reference Pearson is unweighted
    E, d = obs.shape
    xs = x_flat[rows_sorted]
    ys = y_flat[rows_sorted]
    ne = np.maximum(counts, 1).astype(np.float64)[:, None]
    sum_x = np.add.reduceat(xs, starts, axis=0)
    sum_x2 = np.add.reduceat(xs * xs, starts, axis=0)
    sum_xy = np.add.reduceat(xs * ys[:, None], starts, axis=0)
    sum_y = np.add.reduceat(ys, starts)[:, None]
    sum_y2 = np.add.reduceat(ys * ys, starts)[:, None]
    cov = sum_xy - sum_x * sum_y / ne
    var_x = np.maximum(sum_x2 - sum_x * sum_x / ne, 0.0)
    var_y = np.maximum(sum_y2 - sum_y * sum_y / ne, 0.0)
    denom = np.sqrt(var_x * var_y)
    corr = np.where(denom > 0, np.abs(cov) / np.where(denom > 0, denom, 1.0), 0.0)

    target = np.ceil(ratio * np.maximum(counts, 1)).astype(np.int64)
    needs = obs.sum(axis=1) > ratio * np.maximum(counts, 1)
    has_int = obs[:, intercept_col]
    # rank candidate (observed, non-intercept) columns by -corr, stable
    score = np.where(obs, corr, -np.inf)
    score[:, intercept_col] = -np.inf
    col_order = np.argsort(-score, axis=1, kind="stable")
    ranks = np.empty_like(col_order)
    np.put_along_axis(ranks, col_order, np.arange(d)[None, :], axis=1)
    keep_n = np.maximum(target - has_int.astype(np.int64), 1)
    chosen = obs & (ranks < keep_n[:, None])
    chosen[:, intercept_col] = has_int
    return np.where(needs[:, None], chosen, obs)
