"""Online scorer: a GAME model resident on the device (port of
photon_ml_tpu/serving/scorer.py).

The offline scoring path (`GameModel.score_dataset`) builds per-dataset
caches and is shaped for one huge batch; serving needs the transpose — the
MODEL stays resident (fixed-effect coefficient vectors, stacked
random-effect coefficient tables, MF factors, all device tensors built once
at load), and small request batches stream through it padded to a
power-of-two bucket.  Related work keeps the model on the accelerator and
amortizes launches over batched requests for exactly this reason (Snap ML,
arXiv:1803.06333; GPU primal learning, arXiv:2008.03433).

The JAX package jits one program per bucket; the port runs each bucket as
eager torch ops (an elementwise product and a row sum per coordinate, a
clamped gather for every entity table), so nothing compiles.
`bucket_compiles` and `new_compiles` keep the JAX package's meaning all the
same: the buckets a scorer has seen for the first time.  Each batch makes
ONE host-to-device copy (features cast to the tables' dtype on the host,
lanes and staging windows packed beside them) and one copy back.

Entity identity is resolved host-side: each random-effect coordinate
carries an id->row hash map; ids unseen at training time map to row -1 and
contribute score 0, so such rows fall back to fixed-effect-only scores
exactly like the offline path (reference: the missing-score default,
Evaluator.scala:35-45).

Tables are never mutated.  A delta scatter clones the table and writes the
clone (`store.entity.scatter_rows`), then swaps the whole tuple of tables,
as XLA's scatter without donation and the JAX package's tuple swap do: a
batch already reading the old tuple finishes on it (batch-granularity
consistency), and a revert restores the exact bytes.  Every device
operation runs on the device's default stream, which all threads share,
so a table freed by a swap is reused only after the work queued before it.

Models past the device budget serve through the tiered entity store
(`store=StoreConfig(...)`): each random-effect table lives in a
photon_ml_tpu_torch.store.TieredEntityStore — a device-resident HOT
subset addressed by slot, a host warm tier, and sealed cold segments on
disk.  A request chunk's misses ride the chunk's own device copy as a
per-batch staging window; promotion into the hot set is amortized in the
store.  Tiered scores are bit-identical to the fully-resident scorer's.

Entity-sharded serving (`shard=ShardAssignment(...)`, fleet/shards.py):
the scorer holds ONLY its owned slice of every random-effect table (owned
rows in their original order; fixed-effect and MF coordinates replicate
in full), filters every row write to its owned rows, and serves
`score_margins()` legs that `fleet.shards.merge_margins` folds back into
the monolithic scores bit for bit.

Scoring semantics match `GameModel.score_dataset`: the returned value is
the summed margin contribution of every coordinate, WITHOUT offsets or the
inverse link (`mean_prediction` applies the link when callers want means).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.models.game import (
    FactoredRandomEffectModel, FixedEffectModel, GameModel,
    MatrixFactorizationModel, RandomEffectModel,
)
from photon_ml_tpu_torch.ops import losses as L
from photon_ml_tpu_torch.parallel.random_effect import score_by_entity
from photon_ml_tpu_torch.store.entity import scatter_rows
from photon_ml_tpu_torch.telemetry.timings import clock
from photon_ml_tpu_torch.utils.math import ceil_pow2

# byte alignment of each array packed into a batch's one device copy
_ALIGN = 16


@dataclasses.dataclass
class ScoreBatchResult:
    """One scored request batch + the stats the metrics accumulator wants."""

    scores: np.ndarray          # [n] margins, request row order
    num_rows: int
    buckets: List[int]          # padded bucket size per device call
    entity_lookups: int         # id resolutions attempted (all RE + MF)
    entity_hits: int            # resolutions that found a trained row
    new_compiles: int           # bucket shapes first seen by this call


def _id_lookup(entity_ids: np.ndarray) -> dict:
    """Host-side id -> table-row hash map (the serving replacement for the
    offline path's per-dataset vocab joins)."""
    return {v: i for i, v in enumerate(np.asarray(entity_ids).tolist())}


def _resolve_lanes(lookup: dict, ids: np.ndarray) -> np.ndarray:
    return np.fromiter((lookup.get(v, -1) for v in np.asarray(ids).tolist()),
                       dtype=np.int32, count=len(ids))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def to_device(arrays: Dict[object, np.ndarray], device: torch.device
              ) -> Dict[object, torch.Tensor]:
    """Every host array in ONE host-to-device copy: the arrays are packed
    into one byte buffer (each at a 16-byte offset) and viewed back in
    their dtypes and shapes on the device."""
    offsets, total = {}, 0
    for key, a in arrays.items():
        offsets[key] = total
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = np.empty(max(total, _ALIGN), np.uint8)
    for key, a in arrays.items():
        buf[offsets[key]: offsets[key] + a.nbytes] = \
            np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    dev = torch.from_numpy(buf).to(device)
    out = {}
    for key, a in arrays.items():
        lo = offsets[key]
        t = dev[lo: lo + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
        out[key] = t.view(a.shape)
    return out


def _row_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as an elementwise product and a row sum: each row's sum runs
    over the width alone, whatever the bucket's row count."""
    return (x * w).sum(dim=-1)


def _factor_dot(rf, cf, rl, cl) -> torch.Tensor:
    """rowFactor . colFactor per row; 0 where either entity is unseen (the
    reference's inner join default)."""
    ok = (rl >= 0) & (cl >= 0)
    if not (rf.shape[0] and cf.shape[0]):
        return torch.zeros(rl.shape[0], dtype=rf.dtype, device=rf.device)
    rfa = rf[torch.clamp(rl, 0, rf.shape[0] - 1)]
    cfa = cf[torch.clamp(cl, 0, cf.shape[0] - 1)]
    s = (rfa * cfa).sum(dim=-1)
    return torch.where(ok, s, torch.zeros_like(s))


class CompiledScorer:
    """Device-resident GAME model + bucketed scoring.

    `score(features, ids)` takes per-shard feature rows
    (`{shard: [n, d]}`) and per-entity-type raw ids (`{re_type: [n]}`),
    pads each chunk to the smallest power-of-two bucket
    (`utils.math.ceil_pow2`, the same rule training prep buckets with),
    and scores it in one pass of torch ops on `device` (None means cuda,
    which raises without CUDA).  `warmup()` runs every bucket once, so the
    first requests meet a warm allocator and warm libraries.
    """

    def __init__(self, model: GameModel, *, max_batch: int = 1024,
                 min_bucket: int = 8, version: Optional[str] = None,
                 store=None, store_dir: Optional[str] = None,
                 shard=None, device=None):
        if max_batch < 1 or min_bucket < 1:
            raise ValueError("max_batch and min_bucket must be >= 1")
        self.model = model
        self.version = version
        # entity-sharded serving (fleet/shards.py): a ShardAssignment
        # makes this scorer hold ONLY its owned slice of every
        # random-effect table (FE/MF coordinates replicate in full), and
        # filter replicated delta/row-state scatters to owned rows
        self.shard = shard
        self.device = resolve_device(device)
        self.max_batch = int(ceil_pow2(max_batch))
        self.min_bucket = min(int(ceil_pow2(min_bucket)), self.max_batch)
        self._loss = L.TASK_LOSSES.get(model.task_type)
        # tiered-store serving (photon_ml_tpu_torch/store/): every RE table
        # lives behind a TieredEntityStore instead of fully device-resident
        if store is not None and store_dir is None:
            raise ValueError("store=StoreConfig(...) requires store_dir "
                             "(the cold tier's segment directory)")
        if store is not None and store.overlay_rows < self.max_batch:
            raise ValueError(
                f"store overlay_rows ({store.overlay_rows}) must cover "
                f"the largest scoring chunk (max_batch={self.max_batch}):"
                " a single batch could otherwise miss more distinct rows "
                "than the staging overlay holds")
        self._stores: Dict[str, object] = {}

        # static structure of the scoring pass + device tables
        self._fe_meta: List[Tuple[str, str]] = []          # (name, shard)
        self._re_meta: List[Tuple[str, str, str]] = []     # (name, shard, re_type)
        self._mf_meta: List[Tuple[str, str, str]] = []     # (name, row_t, col_t)
        self._lookups: Dict[str, dict] = {}                # lane key -> id map
        self._table_slot: Dict[str, int] = {}              # RE name -> slot
        self._overlay_slot: Dict[str, int] = {}            # store coord -> slot
        self._entity_ids: Dict[str, np.ndarray] = {}       # RE name -> ids held
        self._shard_row_maps: Dict[str, dict] = {}         # RE name -> full->local
        self._logical_rows: Dict[str, int] = {}            # RE name -> owned rows
        self.shard_rows_dropped = 0   # unowned delta/replay rows filtered
        tables = []
        shard_dims: Dict[str, int] = {}

        def on_device(t) -> torch.Tensor:
            return torch.as_tensor(t).detach().to(self.device)

        def shard_slice(m):
            """A RE coordinate's (entity_ids, table, full->local map,
            owned rows) under this scorer's shard assignment — owned rows
            only, ORIGINAL row order preserved (so the slice is a pure
            filter of the full table and per-shard audits hash the same
            bytes on the full scorer's filtered view and the shard's
            resident table).  A shard owning zero entities keeps one
            never-addressed zero row so the gathers stay well-formed; its
            logical row count is 0 and audits hash the empty slice."""
            ids_full = np.asarray(m.entity_ids)
            table_full = m.global_coefficients()
            if self.shard is None:
                return ids_full, table_full, None, len(ids_full)
            mask = self.shard.spec.owned_mask(ids_full, self.shard.index)
            owned = np.nonzero(mask)[0]
            row_map = {int(full): local
                       for local, full in enumerate(owned.tolist())}
            table_own = _host(table_full)[owned]
            if len(owned) == 0:
                table_own = np.zeros((1, table_own.shape[1]),
                                     table_own.dtype)
            return ids_full[mask], torch.from_numpy(table_own), row_map, \
                len(owned)

        def note_shard(shard, dim, owner):
            prev = shard_dims.setdefault(shard, int(dim))
            if prev != int(dim):
                raise ValueError(
                    f"coordinate {owner!r} scores shard {shard!r} at width "
                    f"{int(dim)} but another coordinate uses width {prev}")

        for name, m in model.coordinates.items():
            if isinstance(m, FixedEffectModel):
                w = on_device(m.glm.coefficients.means)
                note_shard(m.feature_shard, w.shape[-1], name)
                self._fe_meta.append((name, m.feature_shard))
                tables.append(w)
            elif isinstance(m, (RandomEffectModel, FactoredRandomEffectModel)):
                # stacked per-entity table in the ORIGINAL shard space:
                # projected/factored coordinates materialize P^T c once at
                # load so serving is a single gather + row dot per request
                ids, table, row_map, logical = shard_slice(m)
                self._entity_ids[name] = ids
                self._logical_rows[name] = logical
                if row_map is not None:
                    self._shard_row_maps[name] = row_map
                note_shard(m.feature_shard, table.shape[-1], name)
                self._re_meta.append((name, m.feature_shard,
                                      m.random_effect_type))
                self._table_slot[name] = len(tables)
                if store is not None:
                    from photon_ml_tpu_torch.store import TieredEntityStore
                    st = TieredEntityStore.create(
                        os.path.join(store_dir, name.replace("/", "_")),
                        _host(table), store,
                        entity_ids=ids if logical else
                        np.asarray(["\0__shard_pad__"], dtype=object),
                        name=name, device=self.device)
                    self._stores[name] = st
                    tables.append(st.table())
                    # the staging window rides as its own table: a batch's
                    # missed-row values score out of it (built host-side
                    # per batch, shipped with the batch's own copy) while
                    # promotion into the main hot table stays amortized.
                    # The entry here is a placeholder of its shape.
                    self._overlay_slot[name] = len(tables)
                    tables.append(torch.zeros(
                        (st.overlay_rows, st.dim), dtype=st.torch_dtype,
                        device=self.device))
                else:
                    self._lookups[name] = _id_lookup(ids) if logical else {}
                    tables.append(on_device(table))
            elif isinstance(m, MatrixFactorizationModel):
                self._mf_meta.append((name, m.row_effect_type,
                                      m.col_effect_type))
                self._lookups[name + "/row"] = _id_lookup(m.row_ids)
                self._lookups[name + "/col"] = _id_lookup(m.col_ids)
                tables.append(on_device(m.row_factors))
                tables.append(on_device(m.col_factors))
            else:
                raise TypeError(f"unknown coordinate model type {type(m)}")
        if not tables:
            raise ValueError("model has no coordinates to serve")
        # deliberately lock-free: delta publishers replace the WHOLE tuple
        # (never mutate in place) and scoring threads read it once per
        # batch — atomic publish at batch granularity
        self._tables = tuple(tables)  # photonlint: guarded-by=atomic
        self.feature_shards: Dict[str, int] = shard_dims
        self.entity_types = sorted(
            {t for _, _, t in self._re_meta}
            | {t for _, r, c in self._mf_meta for t in (r, c)})
        dtype = self._tables[0].dtype
        for t in self._tables[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        self._dtype = dtype
        self._np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        self._seen_buckets: set = set()
        self.bucket_compiles = 0
        self.warmup_s = 0.0
        self.warmed = False
        # online-update version vector: seq of the newest applied delta
        # (0 = pristine full-model load) + lifetime apply/revert counts
        self.delta_seq = 0
        self.deltas_applied = 0
        self.deltas_reverted = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_model_dir(cls, model_dir: str, *, max_batch: int = 1024,
                       min_bucket: int = 8, version: Optional[str] = None,
                       warmup: bool = True, store=None,
                       store_dir: Optional[str] = None, shard=None,
                       device=None, dtype: torch.dtype = torch.float32
                       ) -> "CompiledScorer":
        """A scorer over a model directory in any layout the port's
        models/io.py reads (npz, Avro, the Scala reference's), loaded onto
        `device` in `dtype`."""
        from photon_ml_tpu_torch.models.io import load_game_model
        device = resolve_device(device)
        model, _config = load_game_model(model_dir, device=device,
                                         dtype=dtype)
        scorer = cls(model, max_batch=max_batch, min_bucket=min_bucket,
                     version=version, store=store, store_dir=store_dir,
                     shard=shard, device=device)
        if warmup:
            scorer.warmup()
        return scorer

    def bucket_sizes(self) -> List[int]:
        out, b = [], self.min_bucket
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        out.append(self.max_batch)
        return out

    def _lane_names(self) -> List[str]:
        names = []
        for name, _, _ in self._re_meta:
            names.append(name)
            if name in self._stores:
                names.append(name + "@stage")
        names += [name + side for name, _, _ in self._mf_meta
                  for side in ("/row", "/col")]
        return names

    def warmup(self) -> float:
        """Run every bucket once now, so no request is the first of its
        shape; store-backed tables warm too."""
        t0 = clock()
        with telemetry.span("serve_warmup", version=self.version):
            for st in self._stores.values():
                st.warmup()
            for b in self.bucket_sizes():
                xs = {s: np.zeros((b, d), np.float64)
                      for s, d in self.feature_shards.items()}
                lanes = {k: np.full(b, -1, np.int32)
                         for k in self._lane_names()}
                _host(self._run_bucket(xs, lanes, b))
                if self.shard is not None:
                    # sharded scorers serve score_margins() legs: warm them
                    _host(self._run_bucket(xs, lanes, b, margins=True)[0])
        self.warmup_s = clock() - t0
        self.warmed = True
        return self.warmup_s

    # -- the device pass ---------------------------------------------------

    def _margins(self, tables, xs, lanes) -> List[torch.Tensor]:
        """Per-coordinate margins for one padded bucket, in
        `coordinate_meta()` order (FE row dots, RE gather-dots, MF factor
        dots), mirroring GameModel.score_dataset coordinate by coordinate.
        A tiered coordinate's hot-table and staging-window contributions
        combine into ONE margin (a row lives in exactly one of the two, the
        other lane is -1 -> 0)."""
        i = 0
        margins = []
        for _name, shard in self._fe_meta:
            margins.append(_row_dot(xs[shard], tables[i]))
            i += 1
        for name, shard, _re_type in self._re_meta:
            z = score_by_entity(tables[i], xs[shard], lanes[name])
            i += 1
            if name in self._stores:
                z = z + score_by_entity(tables[i], xs[shard],
                                        lanes[name + "@stage"])
                i += 1
            margins.append(z)
        for name, _row_t, _col_t in self._mf_meta:
            margins.append(_factor_dot(tables[i], tables[i + 1],
                                       lanes[name + "/row"],
                                       lanes[name + "/col"]))
            i += 2
        return margins

    def coordinate_meta(self) -> List[Dict[str, str]]:
        """The coordinate fold order as data — one ordered entry per
        margin the scoring pass adds (FE, then RE, then MF, each in model
        order)."""
        out: List[Dict[str, str]] = []
        for name, shard in self._fe_meta:
            out.append({"name": name, "kind": "fixed",
                        "feature_shard": shard})
        for name, shard, re_type in self._re_meta:
            out.append({"name": name, "kind": "random",
                        "feature_shard": shard, "entity_type": re_type})
        for name, row_t, col_t in self._mf_meta:
            out.append({"name": name, "kind": "matrix",
                        "row_type": row_t, "col_type": col_t})
        return out

    def _run_bucket(self, xs, lanes, bucket: int, store_tables=None,
                    margins: bool = False):
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.bucket_compiles += 1
        # ONE host->device copy for every feature shard, lane array and
        # staged-miss window (the dtype cast stays host-side)
        host = {("x", s): np.asarray(x, self._np_dtype)
                for s, x in xs.items()}
        host.update({("lane", k): np.asarray(v, np.int64)
                     for k, v in lanes.items()})
        if store_tables:
            host.update({("window", name): w
                         for name, (_t, w) in store_tables.items()})
        dev = to_device(host, self.device)
        tables = self._tables
        if store_tables:
            # tiered mode: each chunk scores against the EXACT hot-table
            # snapshot its slots were resolved into (a concurrent promotion
            # replaces the store's table, never mutating this snapshot)
            # plus its own private staging window
            t = list(tables)
            for name, (table, _w) in store_tables.items():
                t[self._table_slot[name]] = table
                t[self._overlay_slot[name]] = dev[("window", name)]
            tables = tuple(t)
        dev_xs = {s: dev[("x", s)] for s in xs}
        dev_lanes = {k: dev[("lane", k)] for k in lanes}
        per = self._margins(tables, dev_xs, dev_lanes)
        if margins:
            return tuple(per)
        total = per[0]
        for z in per[1:]:
            total = total + z
        return total

    # -- online row-level updates ------------------------------------------

    def updatable_coordinates(self) -> List[Tuple[str, str, str]]:
        """(name, feature_shard, re_type) of every coordinate whose stacked
        table accepts row-level delta swaps (plain + factored random
        effects; MF factor pairs are not online-updatable — prefer a full
        refit there)."""
        return list(self._re_meta)

    def re_table(self, name: str) -> torch.Tensor:
        """The device-resident stacked table of one RE coordinate
        (original shard space — what apply_delta scatters into; in tiered
        mode this is the HOT subset, addressed by slot)."""
        st = self._stores.get(name)
        if st is not None:
            return st.table()
        return self._tables[self._table_slot[name]]

    def entity_row(self, name: str, entity_id) -> int:
        """Table row of a raw entity id under coordinate `name`
        (-1 = unseen at training time; such entities cannot be
        online-updated — the table has no row to anchor at)."""
        st = self._stores.get(name)
        if st is not None:
            return st.resolve_one(entity_id)
        return self._lookups[name].get(entity_id, -1)

    def entity_store(self, name: str):
        """The TieredEntityStore behind one coordinate (None when the
        table is fully device-resident)."""
        return self._stores.get(name)

    def gather_rows(self, name: str, rows: np.ndarray) -> torch.Tensor:
        """Gather of table rows (delta priors / anchors), on the scorer's
        device.  Rows out of range clamp, as XLA's gather does; tiered
        mode reads the authoritative warm/cold bytes host-side —
        bit-exact with what the hot tier serves."""
        rows = np.asarray(rows, np.int64)
        st = self._stores.get(name)
        if st is not None:
            return torch.from_numpy(st.gather_rows(rows)).to(self.device)
        table = self.re_table(name)
        idx = np.clip(rows, 0, max(table.shape[0] - 1, 0))
        return table[torch.from_numpy(idx).to(self.device)]

    def _filter_shard_rows(self, name: str, rows: np.ndarray,
                           values: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """The shard-filtering chokepoint of EVERY row write: replicated
        deltas, rollback row-state replays, and snapshot bootstraps all
        carry FULL-model row indices; a sharded scorer keeps only its
        owned rows, remapped to its local (filtered) table space.
        Unowned rows drop silently — their owner's replica applies them —
        and are counted in `shard_rows_dropped`."""
        row_map = self._shard_row_maps.get(name)
        if row_map is None:
            return rows, values
        keep = [i for i, r in enumerate(rows.tolist()) if int(r) in row_map]
        self.shard_rows_dropped += len(rows) - len(keep)
        local = np.asarray([row_map[int(rows[i])] for i in keep], np.int64)
        return local, values[keep]

    def _scatter_coordinate(self, name: str, rows: np.ndarray,
                            values: np.ndarray,
                            promote: bool = False) -> None:
        slot = self._table_slot.get(name)
        if slot is None:
            known = sorted(self._table_slot)
            raise KeyError(f"coordinate {name!r} has no online-updatable "
                           f"table (updatable: {known})")
        rows = np.asarray(rows, np.int64)
        values = np.asarray(values)
        rows, values = self._filter_shard_rows(name, rows, values)
        if len(rows) == 0 and self.shard is not None:
            return  # this shard owns none of the delta's rows
        st = self._stores.get(name)
        if st is not None:
            # tiered mode: the delta lands in whatever tier each row
            # lives in (warm always, hot write-through for resident rows,
            # promote=True pulls cold rows hot — the feedback path)
            if values.shape != (len(rows), st.dim):
                raise ValueError(
                    f"delta values for {name!r} must be [{len(rows)}, "
                    f"{st.dim}], got {values.shape}")
            st.update_rows(rows, values, promote=promote)
            return
        table = self._tables[slot]
        if values.shape != (len(rows), table.shape[1]):
            raise ValueError(
                f"delta values for {name!r} must be [{len(rows)}, "
                f"{table.shape[1]}], got {values.shape}")
        if len(rows) and (int(rows.max()) >= table.shape[0]
                          or int(rows.min()) < 0):
            # JAX drops such lanes; on CUDA one would be a device-side
            # assert that ends the process's CUDA context
            raise ValueError(
                f"delta rows [{int(rows.min())}, {int(rows.max())}] out of "
                f"range for {name!r} (table has {table.shape[0]} rows)")
        tables = list(self._tables)
        tables[slot] = scatter_rows(table, rows, values)
        # one atomic tuple swap: a concurrent score() batch reads either
        # the old or the new tuple — batch-granularity consistency, same
        # contract as a full-model hot swap
        self._tables = tuple(tables)

    def scatter_rows(self, name: str, rows: np.ndarray,
                     values: np.ndarray) -> None:
        """Scatter raw row values into one coordinate's live table (the
        replication layer's replay primitive: rollback records and
        snapshot bootstraps carry explicit row states rather than
        ModelDeltas).  Callers serialize through the registry lock, same
        contract as apply_delta."""
        self._scatter_coordinate(name, rows, values)

    def warmup_delta(self, max_rows: int = 64) -> float:
        """Run a discarded scatter of every pow-2 row count up to
        `max_rows` on every updatable table (the JAX package compiles its
        delta scatter programs here; the port warms the allocator for the
        table-sized clone a scatter makes).  Tiered tables warm their
        store."""
        t0 = clock()
        with telemetry.span("replica_delta_warmup", version=self.version):
            for name, _shard, _re_type in self.updatable_coordinates():
                st = self._stores.get(name)
                if st is not None:
                    if not st.warmed:
                        st.warmup()
                    continue
                table = self.re_table(name)
                k = 1
                bound = int(ceil_pow2(max(max_rows, 1)))
                while k <= bound:
                    rows = np.arange(min(k, table.shape[0]), dtype=np.int64)
                    vals = np.zeros((len(rows), table.shape[1]))
                    # result discarded: the live table is never touched
                    _host(scatter_rows(table, rows, vals)[:1])
                    k <<= 1
        return clock() - t0

    def table_hashes(self) -> Dict[str, str]:  # photonlint: flush-point -- audit endpoint: one deliberate full-table readback per call, never on the scoring path
        """sha256 of every device table's exact byte content, keyed by
        coordinate lane (MF factor pairs hash as name/row + name/col).
        The fleet audit primitive: two replicas whose version vectors AND
        table hashes agree converged bit-identically.  One deliberate
        full-table read-back per call, never on the scoring path."""
        def digest(a) -> str:
            return hashlib.sha256(
                np.ascontiguousarray(_host(a)).tobytes()).hexdigest()

        i = 0
        out: Dict[str, str] = {}
        for name, _shard in self._fe_meta:
            out[name] = digest(self._tables[i])
            i += 1
        for name, _shard, _re_type in self._re_meta:
            st = self._stores.get(name)
            # tiered mode hashes the LOGICAL table (cold + warm overlay):
            # two replicas whose tiering histories differ but whose row
            # values agree hash identically
            rows = _host(st.full_table() if st is not None
                         else self._tables[i])
            if self.shard is not None:
                # sharded mode hashes the OWNED slice (a zero-owned
                # shard's never-addressed pad row is excluded), so the
                # hash equals the full scorer's shard_table_hashes() of
                # the same filtered rows
                rows = rows[:self._logical_rows[name]]
            out[name] = digest(rows)
            i += 2 if st is not None else 1
        for name, _row_t, _col_t in self._mf_meta:
            for side in ("/row", "/col"):
                out[name + side] = digest(self._tables[i])
                i += 1
        return out

    def apply_delta(self, delta) -> None:
        """Scatter a ModelDelta's changed rows into the live tables.
        Callers serialize through the registry lock; scoring threads need
        no lock (the table tuple swap is atomic).  Tiered tables land the
        rows in whatever tier they live in, and PROMOTE cold rows hot — an
        entity the traffic cares enough about to send feedback for belongs
        in the hot set."""
        for name, cd in delta.coordinates.items():
            self._scatter_coordinate(name, cd.rows, cd.values,
                                     promote=True)
        self.delta_seq = delta.seq
        self.deltas_applied += 1

    def revert_delta(self, delta) -> None:
        """Scatter a delta's pre-delta rows back (exact rollback: restores
        the bit pattern the rows had before apply_delta — in tiered mode
        across every tier the delta touched)."""
        for name, cd in delta.coordinates.items():
            self._scatter_coordinate(name, cd.rows, cd.prior)
        self.delta_seq = delta.seq - 1
        self.deltas_reverted += 1

    # -- tiered-store observability ----------------------------------------

    def store_totals(self) -> Dict[str, int]:
        """Cumulative tier counters summed over every store-backed
        coordinate (the ServingMetrics probe; all zeros when fully
        resident)."""
        from photon_ml_tpu_torch.store.entity import store_totals
        return store_totals(self._stores)

    def store_health(self) -> Optional[Dict]:
        """Per-coordinate residency + the aggregate hot hit rate for
        /healthz (None when fully resident)."""
        if not self._stores:
            return None
        totals = self.store_totals()
        lookups = (totals["hot_hits"] + totals["warm_hits"]
                   + totals["cold_misses"])
        return {
            "hit_rate": (round(totals["hot_hits"] / lookups, 4)
                         if lookups else None),
            "promotions": totals["promotions"],
            "spills": totals["spills"],
            "coordinates": {name: st.residency()
                            for name, st in self._stores.items()},
        }

    def flush_stores(self) -> int:
        """Durably spill every dirty warm segment (shutdown/seal hook).
        Returns segments written."""
        return sum(st.flush() for st in self._stores.values())

    # -- request scoring ---------------------------------------------------

    def validate_request(self, features: Dict[str, np.ndarray],
                         ids: Dict[str, np.ndarray]) -> int:
        """Shape/coverage check -> the request's row count.  Raised errors
        are per-request (the batcher propagates them to one caller, not the
        whole batch)."""
        missing = sorted(set(self.feature_shards) - set(features))
        if missing:
            raise ValueError(f"request is missing feature shard(s) {missing}"
                             f" (model scores {sorted(self.feature_shards)})")
        n = None
        for shard, want in self.feature_shards.items():
            x = np.asarray(features[shard])
            if x.ndim != 2 or x.shape[1] != want:
                raise ValueError(
                    f"feature shard {shard!r} must be [n, {want}], got "
                    f"shape {x.shape}")
            if n is None:
                n = x.shape[0]
            elif x.shape[0] != n:
                raise ValueError(
                    f"feature shard {shard!r} has {x.shape[0]} rows; other "
                    f"shards have {n}")
        missing_ids = sorted(set(self.entity_types) - set(ids or {}))
        if missing_ids:
            raise ValueError(
                f"request is missing entity id column(s) {missing_ids} "
                f"(model has random effects over {self.entity_types})")
        for t in self.entity_types:
            col = np.asarray(ids[t])
            if n is None:
                n = len(col)
            if col.shape != (n,):
                raise ValueError(
                    f"id column {t!r} must be [{n}], got shape {col.shape}")
        if n is None or n == 0:
            raise ValueError("empty request")
        return n

    def _lanes_for_chunk(self, ids, lo, hi):
        lanes, hits, lookups = {}, 0, 0
        store_tables = {}
        for name, _shard, re_type in self._re_meta:
            col = np.asarray(ids[re_type])[lo:hi]
            st = self._stores.get(name)
            if st is not None:
                # tiered mode: resolve ids -> global rows, then stage the
                # chunk's misses into the per-batch staging window
                # (promotion into the main table is amortized); lanes
                # are SLOTS into the returned snapshot/window
                rows = st.resolve(col)
                slots, stage, table, staged_vals = st.lookup_slots(rows)
                window = np.zeros((st.overlay_rows, st.dim), st.dtype)
                window[: len(staged_vals)] = staged_vals
                lanes[name] = slots
                lanes[name + "@stage"] = stage
                store_tables[name] = (table, window)
                hits += int((rows >= 0).sum()); lookups += len(rows)
                continue
            ln = _resolve_lanes(self._lookups[name], col)
            lanes[name] = ln
            hits += int((ln >= 0).sum()); lookups += len(ln)
        for name, row_t, col_t in self._mf_meta:
            for side, t in (("/row", row_t), ("/col", col_t)):
                ln = _resolve_lanes(self._lookups[name + side],
                                    np.asarray(ids[t])[lo:hi])
                lanes[name + side] = ln
                hits += int((ln >= 0).sum()); lookups += len(ln)
        return lanes, hits, lookups, store_tables

    def _chunks(self, features, ids, n):
        """(lo, hi, padded features, padded lanes, bucket, hits, lookups,
        store_tables) per max_batch chunk of a request."""
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            m = hi - lo
            bucket = min(max(int(ceil_pow2(m)), self.min_bucket),
                         self.max_batch)
            pad = bucket - m
            xs = {}
            for shard in self.feature_shards:
                x = np.asarray(features[shard])[lo:hi]
                xs[shard] = (x if pad == 0 else
                             np.pad(x, ((0, pad), (0, 0))))
            lanes, h, lk, store_tables = self._lanes_for_chunk(ids, lo, hi)
            if pad:
                lanes = {k: np.pad(v, (0, pad), constant_values=-1)
                         for k, v in lanes.items()}
            yield lo, hi, xs, lanes, bucket, h, lk, store_tables

    def score(self, features: Dict[str, np.ndarray],
              ids: Optional[Dict[str, np.ndarray]] = None,
              ) -> ScoreBatchResult:
        """Margins for a request batch of any size (chunked at max_batch)."""
        ids = ids or {}
        n = self.validate_request(features, ids)
        out = np.empty(n, np.float64)
        buckets: List[int] = []
        hits = lookups = 0
        compiles0 = self.bucket_compiles
        for lo, hi, xs, lanes, bucket, h, lk, store_tables in \
                self._chunks(features, ids, n):
            hits += h; lookups += lk
            buckets.append(bucket)
            z = self._run_bucket(xs, lanes, bucket,
                                 store_tables=store_tables)
            out[lo:hi] = _host(z)[:hi - lo]
        return ScoreBatchResult(
            scores=out, num_rows=n, buckets=buckets,
            entity_lookups=lookups, entity_hits=hits,
            new_compiles=self.bucket_compiles - compiles0)

    def score_margins(self, features: Dict[str, np.ndarray],
                      ids: Optional[Dict[str, np.ndarray]] = None,
                      ) -> Dict[str, np.ndarray]:
        """Per-coordinate margins for a request batch (chunked at
        max_batch like `score`), keyed by coordinate name in
        `coordinate_meta()` order.  Margins keep the COMPUTE dtype (`score`
        casts to f64 only at the end); unseen entities contribute exactly
        0.0."""
        ids = ids or {}
        n = self.validate_request(features, ids)
        meta = self.coordinate_meta()
        out = {m["name"]: np.empty(n, self._np_dtype) for m in meta}
        for lo, hi, xs, lanes, bucket, _h, _lk, store_tables in \
                self._chunks(features, ids, n):
            margins = self._run_bucket(xs, lanes, bucket,
                                       store_tables=store_tables,
                                       margins=True)
            for cm, z in zip(meta, margins):
                out[cm["name"]][lo:hi] = _host(z)[:hi - lo]
        return out

    # -- entity-sharded serving (fleet/shards.py) --------------------------

    def shard_info(self) -> Optional[Dict[str, object]]:
        """This scorer's shard identity + owned-row counts (the /healthz
        and probe surface the front groups replicas by); None when the
        scorer holds the full model."""
        if self.shard is None:
            return None
        return {**self.shard.to_dict(),
                "owned_rows": {name: self._logical_rows[name]
                               for name, _s, _t in self._re_meta},
                "rows_dropped": self.shard_rows_dropped}

    def shard_table_hashes(self, spec, shard_index: int) -> Dict[str, str]:
        """The per-shard audit on a FULL (publisher) scorer: sha256 of
        every lane's rows FILTERED to `shard_index`'s owned entities
        (original row order) — exactly the bytes a converged shard
        replica's `table_hashes()` reports, since its resident table IS
        that filtered slice.  FE/MF lanes replicate in full and hash
        unfiltered."""
        if self.shard is not None:
            raise ValueError("shard_table_hashes audits the FULL model; "
                             "this scorer already holds only shard "
                             f"{self.shard.index}")
        full = self.table_hashes()
        out: Dict[str, str] = {}
        for name, _shard in self._fe_meta:
            out[name] = full[name]
        for name, _shard, _re_type in self._re_meta:
            st = self._stores.get(name)
            table = _host(st.full_table() if st is not None
                          else self._tables[self._table_slot[name]])
            mask = spec.owned_mask(self._entity_ids[name], shard_index)
            out[name] = hashlib.sha256(
                np.ascontiguousarray(table[mask]).tobytes()).hexdigest()
        for name, _row_t, _col_t in self._mf_meta:
            for side in ("/row", "/col"):
                out[name + side] = full[name + side]
        return out

    def mean_prediction(self, scores: np.ndarray,
                        offsets: Optional[np.ndarray] = None) -> np.ndarray:
        """Inverse link over margins (+ offsets), like GameModel.predict,
        on the host in float64."""
        if self._loss is None:
            raise ValueError(
                f"task {self.model.task_type!r} has no mean function")
        z = np.asarray(scores, np.float64)
        if offsets is not None:
            z = z + np.asarray(offsets, np.float64)
        return self._loss.mean(torch.from_numpy(z)).numpy()

    def requests_from_dataset(self, dataset, rows: np.ndarray
                              ) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, np.ndarray]]:
        """Slice a GameDataset into (features, ids) request form — raw ids
        recovered through the dataset vocab; rows whose entity index is -1
        get a sentinel id no model contains (they stay fixed-effect-only).
        Sparse shards densify per request slice (serving requests are
        small dense rows by construction)."""
        def slice_rows(x):
            if hasattr(x, "tocsr"):  # scipy sparse shard
                return np.asarray(x.tocsr()[rows].todense())
            return np.asarray(x)[rows]

        feats = {s: slice_rows(dataset.feature_shards[s])
                 for s in self.feature_shards}
        ids = {}
        for t in self.entity_types:
            idx = np.asarray(dataset.entity_indices[t])[rows]
            vocab = np.asarray(dataset.entity_vocabs[t], dtype=object)
            raw = vocab[np.maximum(idx, 0)].copy()
            raw[idx < 0] = "\0__unseen__"
            ids[t] = raw
        return feats, ids
