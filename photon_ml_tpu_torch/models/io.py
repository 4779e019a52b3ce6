"""Model persistence (port of photon_ml_tpu/models/io.py): the npz
layout, the Avro interchange layout and the Scala reference's own layout,
each written and read exactly as the JAX package does, so a model
directory written by either package loads in the other.  Loading takes
`device` (None means cuda, which raises without CUDA) and `dtype`
(float32 by default, as the JAX package computes without x64).  Online
model deltas (`save_model_delta`/`load_model_delta`) are the manifest-
sealed `delta.npz` + `delta-metadata.json` pair the JAX package writes,
so a delta directory either package writes loads in the other.

The JAX package's description of the layouts:

Rebuild of ModelProcessingUtils (photon-client/.../data/avro/
ModelProcessingUtils.scala:58-669): GAME models persist to a directory tree

    <dir>/model-metadata.json                     # task, config, coordinates
    <dir>/fixed-effect/<name>/coefficients.npz    # means (+variances)
    <dir>/random-effect/<name>/coefficients.npz   # [E, d_local] + projection
                                                  # + entity ids + global dim

mirroring the reference's fixed-effect/<coord>/coefficients/part-*.avro and
random-effect/<coord>/... layout with npz in place of Avro records (an Avro
export for cross-tool parity lives in photon_ml_tpu_torch/data/avro_io.py).
model-metadata.json embeds the full training config JSON exactly like the
reference embeds optimizer configs for scoring-side reproducibility
(ModelProcessingUtils.scala:517-559).  Feature names are stored when an
IndexMap is provided, matching the reference's human-readable name.term
output.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import (IndexMap, IndexMapCollection,
                                          feature_key)
from photon_ml_tpu_torch.game.config import GameTrainingConfig
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import (
    FactoredRandomEffectModel, FixedEffectModel, GameModel,
    MatrixFactorizationModel, RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.utils.durable import (atomic_write_json,
                                               atomic_write_text, write_marker)

_FORMAT_VERSION = 1


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _putter(device, dtype):
    """-> a function moving a host array to `device` in `dtype`."""
    dev = resolve_device(device)
    return lambda a: torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    """A host array on `ref`'s device in `ref`'s dtype."""
    return torch.as_tensor(np.asarray(a)).to(device=ref.device, dtype=ref.dtype)


def _shard_index_map(index_maps, shard, dim) -> IndexMap:
    """The shard's map, or a synthesized zero-padded one (sorted order ==
    column order) when none was recorded — Avro records key features by
    name.term, so SOME map must exist."""
    imap = (index_maps or {}).get(shard)
    if imap is not None:
        return imap
    return IndexMap.from_keys(
        [feature_key(f"{j:09d}") for j in range(dim - 1)], add_intercept=True)


def save_game_model(
    model: GameModel,
    directory: str,
    config: Optional[GameTrainingConfig] = None,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    format: str = "npz",
) -> None:
    """reference: ModelProcessingUtils.saveGameModelsToHDFS (scala:71-135).

    `format="avro"` writes the reference's interchange records instead of
    npz: BayesianLinearModelAvro per fixed-effect model and per random-effect
    entity (original feature space, name.term keys), LatentFactorAvro for
    matrix factorization — a model the Spark implementation can read.
    Factored random effects materialize to per-entity original-space models
    on Avro save (the reference persists original-space models too).

    `model.save` is a fault-injection site (utils/faults.py): chaos runs
    inject write failures here to prove checkpointing surfaces them."""
    from photon_ml_tpu_torch.utils import faults
    faults.fire("model.save", directory=os.path.basename(directory.rstrip("/")))
    if format == "avro":
        return _save_game_model_avro(model, directory, config, index_maps)
    if format == "reference":
        return save_game_model_reference_layout(model, directory,
                                                index_maps=index_maps)
    if format != "npz":
        raise ValueError(f"unknown model format {format!r}")
    os.makedirs(directory, exist_ok=True)
    if index_maps:
        IndexMapCollection(dict(index_maps)).save(
            os.path.join(directory, "index-maps"))
    meta = {"format_version": _FORMAT_VERSION, "task_type": model.task_type,
            "coordinates": {}, "config": config.to_dict() if config else None}
    for name, m in model.coordinates.items():
        if isinstance(m, FixedEffectModel):
            sub = os.path.join(directory, "fixed-effect", name)
            os.makedirs(sub, exist_ok=True)
            arrays = {"means": _host(m.glm.coefficients.means)}
            if m.glm.coefficients.variances is not None:
                arrays["variances"] = _host(m.glm.coefficients.variances)
            imap = (index_maps or {}).get(m.feature_shard)
            if imap is not None:
                arrays["feature_keys"] = imap.index_to_key.astype(object)
            np.savez_compressed(os.path.join(sub, "coefficients.npz"), **arrays)
            meta["coordinates"][name] = {"kind": "fixed_effect",
                                         "feature_shard": m.feature_shard}
        elif isinstance(m, RandomEffectModel):
            sub = os.path.join(directory, "random-effect", name)
            os.makedirs(sub, exist_ok=True)
            arrays = {"coefficients": _host(m.coefficients),
                      "entity_ids": _host(m.entity_ids).astype(object),
                      "global_dim": _host(m.global_dim)}
            if m.projection is not None:
                arrays["projection"] = m.projection
            if m.projection_matrix is not None:
                arrays["projection_matrix"] = _host(m.projection_matrix)
            if m.variances is not None:
                arrays["variances"] = _host(m.variances)
            np.savez_compressed(os.path.join(sub, "coefficients.npz"), **arrays)
            meta["coordinates"][name] = {
                "kind": "random_effect",
                "random_effect_type": m.random_effect_type,
                "feature_shard": m.feature_shard}
        elif isinstance(m, FactoredRandomEffectModel):
            sub = os.path.join(directory, "factored-random-effect", name)
            os.makedirs(sub, exist_ok=True)
            np.savez_compressed(
                os.path.join(sub, "coefficients.npz"),
                latent_coefficients=_host(m.latent_coefficients),
                projection=_host(m.projection),
                entity_ids=_host(m.entity_ids).astype(object),
                global_dim=_host(m.global_dim))
            meta["coordinates"][name] = {
                "kind": "factored_random_effect",
                "random_effect_type": m.random_effect_type,
                "feature_shard": m.feature_shard}
        elif isinstance(m, MatrixFactorizationModel):
            # reference: ModelProcessingUtils matrix-factorization save/load
            # (scala:450-516) — row/col latent factors (LatentFactorAvro
            # export lives in data/avro_io.py write_latent_factors_avro)
            sub = os.path.join(directory, "matrix-factorization", name)
            os.makedirs(sub, exist_ok=True)
            np.savez_compressed(
                os.path.join(sub, "factors.npz"),
                row_factors=_host(m.row_factors),
                row_ids=_host(m.row_ids).astype(object),
                col_factors=_host(m.col_factors),
                col_ids=_host(m.col_ids).astype(object))
            meta["coordinates"][name] = {
                "kind": "matrix_factorization",
                "row_effect_type": m.row_effect_type,
                "col_effect_type": m.col_effect_type,
                "task_type": m.task_type}
        else:
            raise TypeError(f"unknown coordinate model type {type(m)}")
    atomic_write_json(os.path.join(directory, "model-metadata.json"), meta)


def _save_game_model_avro(model, directory, config, index_maps) -> None:
    """Avro-format GAME model save (reference interchange artifacts)."""
    from photon_ml_tpu_torch.data.avro_io import (
        write_glm_avro, write_latent_factors_avro, write_random_effect_avro,
    )
    os.makedirs(directory, exist_ok=True)
    meta = {"format_version": _FORMAT_VERSION, "task_type": model.task_type,
            "storage_format": "avro", "coordinates": {},
            "config": config.to_dict() if config else None}
    # every map actually used is persisted — including synthesized ones:
    # Avro records drop zero coefficients, so WITHOUT the map a reload
    # would rebuild a shrunken, shifted feature space
    used_maps: Dict[str, IndexMap] = dict(index_maps or {})
    for name, m in model.coordinates.items():
        if isinstance(m, FixedEffectModel):
            sub = os.path.join(directory, "fixed-effect", name)
            os.makedirs(sub, exist_ok=True)
            means = _host(m.glm.coefficients.means)
            imap = _shard_index_map(index_maps, m.feature_shard, len(means))
            used_maps[m.feature_shard] = imap
            var = m.glm.coefficients.variances
            write_glm_avro(os.path.join(sub, "coefficients.avro"), name,
                           model.task_type, means, imap,
                           None if var is None else _host(var))
            meta["coordinates"][name] = {"kind": "fixed_effect",
                                         "feature_shard": m.feature_shard}
        elif isinstance(m, (RandomEffectModel, FactoredRandomEffectModel)):
            factored = isinstance(m, FactoredRandomEffectModel)
            re = m.to_random_effect_model() if factored else m
            if re.projection_matrix is not None:
                # random-projection RE: Avro records key coefficients by
                # ORIGINAL-space feature; write P^T c, not the projected-space
                # slots (which would alias local slot j to feature j).
                # Projected-space variances have no per-feature meaning and
                # are dropped, like the factored path.
                re = RandomEffectModel(
                    random_effect_type=re.random_effect_type,
                    feature_shard=re.feature_shard, task_type=re.task_type,
                    coefficients=re.global_coefficients(),
                    entity_ids=re.entity_ids, projection=None,
                    global_dim=re.global_dim)
            sub = os.path.join(directory, "random-effect", name)
            os.makedirs(sub, exist_ok=True)
            imap = _shard_index_map(index_maps, re.feature_shard,
                                    re.global_dim)
            used_maps[re.feature_shard] = imap
            write_random_effect_avro(
                os.path.join(sub, "coefficients.avro"), model.task_type,
                re.entity_ids, _host(re.coefficients), imap,
                projection=re.projection,
                variances=(None if re.variances is None
                           else _host(re.variances)))
            if factored:
                # the latent decomposition itself, as LatentFactorAvro
                write_latent_factors_avro(
                    os.path.join(sub, "latent-projection.avro"),
                    [str(k) for k in range(m.latent_dim)],
                    _host(m.projection))
                write_latent_factors_avro(
                    os.path.join(sub, "latent-coefficients.avro"),
                    [str(e) for e in _host(m.entity_ids)],
                    _host(m.latent_coefficients))
            meta["coordinates"][name] = {
                "kind": "random_effect",
                "random_effect_type": re.random_effect_type,
                "feature_shard": re.feature_shard,
                **({"materialized_from": "factored_random_effect"}
                   if factored else {})}
        elif isinstance(m, MatrixFactorizationModel):
            from photon_ml_tpu_torch.data.avro_io import write_latent_factors_avro
            sub = os.path.join(directory, "matrix-factorization", name)
            os.makedirs(sub, exist_ok=True)
            write_latent_factors_avro(os.path.join(sub, "row-factors.avro"),
                                      [str(i) for i in _host(m.row_ids)],
                                      _host(m.row_factors))
            write_latent_factors_avro(os.path.join(sub, "col-factors.avro"),
                                      [str(i) for i in _host(m.col_ids)],
                                      _host(m.col_factors))
            meta["coordinates"][name] = {
                "kind": "matrix_factorization",
                "row_effect_type": m.row_effect_type,
                "col_effect_type": m.col_effect_type,
                "task_type": m.task_type}
        else:
            raise TypeError(f"unknown coordinate model type {type(m)}")
    if used_maps:
        IndexMapCollection(used_maps).save(
            os.path.join(directory, "index-maps"))
    atomic_write_json(os.path.join(directory, "model-metadata.json"), meta)


def load_model_index_maps(directory: str) -> Optional[Dict[str, IndexMap]]:
    """The per-shard feature maps recorded at save time (needed to read
    scoring/validation Avro data in the model's feature space).  For a
    reference-layout directory nothing was recorded, but the maps are fully
    determined by the model records themselves (compact scan order,
    reference: AvroUtils.makeFeatureIndexForModel), so they are rebuilt."""
    path = os.path.join(directory, "index-maps")
    if os.path.isdir(path):
        return IndexMapCollection.load(path).shards
    if _is_reference_layout(directory):
        return _reference_layout_index_maps(directory)
    return None


# -- the Scala reference's own on-disk layout --------------------------------
#
# reference: ModelProcessingUtils.scala:71-135 (save) / :136-238 (load):
#
#   <dir>/model-metadata.json                      # {"modelType": "...", ...}
#   <dir>/fixed-effect/<name>/id-info              # 1 line: featureShardId
#   <dir>/fixed-effect/<name>/coefficients/part-00000.avro
#   <dir>/random-effect/<name>/id-info             # 2 lines: REType, shardId
#   <dir>/random-effect/<name>/coefficients/part-*.avro  (+ _SUCCESS marker)
#
# Coefficients are BayesianLinearModelAvro records; random-effect containers
# hold one record per entity (modelId = entity id), split across Spark
# partition files.

_REFERENCE_TASKS = {
    "LOGISTIC_REGRESSION": "logistic_regression",
    "LINEAR_REGRESSION": "linear_regression",
    "POISSON_REGRESSION": "poisson_regression",
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": "smoothed_hinge_loss_linear_svm",
    "NONE": None,
}


def _is_reference_layout(directory: str) -> bool:
    meta_p = os.path.join(directory, "model-metadata.json")
    if os.path.exists(meta_p):
        try:
            with open(meta_p) as f:
                meta = json.load(f)
        except ValueError:
            return False
        return "modelType" in meta and "coordinates" not in meta
    # pre-metadata reference models: recognized by the id-info files
    for kind in ("fixed-effect", "random-effect"):
        base = os.path.join(directory, kind)
        if os.path.isdir(base):
            for name in os.listdir(base):
                if os.path.exists(os.path.join(base, name, "id-info")):
                    return True
    return False


def _reference_coordinate_dirs(directory: str):
    """-> [(kind, name, shard, re_type, part_files)] sorted by name."""
    out = []
    for kind in ("fixed-effect", "random-effect"):
        base = os.path.join(directory, kind)
        if not os.path.isdir(base):
            continue
        for name in sorted(os.listdir(base)):
            sub = os.path.join(base, name)
            id_info = os.path.join(sub, "id-info")
            coeff_dir = os.path.join(sub, "coefficients")
            if not os.path.isdir(coeff_dir):
                continue
            if not os.path.exists(id_info):
                raise ValueError(
                    f"{sub}: reference-layout coordinate has coefficients "
                    "but no id-info file (expected 1 line for fixed-effect: "
                    "featureShardId; 2 for random-effect: randomEffectType, "
                    "featureShardId)")
            with open(id_info) as f:
                ids = [ln.strip() for ln in f if ln.strip()]
            expected = 1 if kind == "fixed-effect" else 2
            if len(ids) != expected:
                raise ValueError(
                    f"{id_info}: expected {expected} line(s) for a "
                    f"{kind} coordinate, got {len(ids)}: {ids!r}")
            if kind == "fixed-effect":
                (shard,), re_type = ids, None
            else:
                re_type, shard = ids
            parts = sorted(
                os.path.join(coeff_dir, fn) for fn in os.listdir(coeff_dir)
                if not fn.startswith(("_", ".")))
            if not parts:
                raise ValueError(f"{coeff_dir}: no coefficient part files")
            out.append((kind, name, shard, re_type, parts))
    if not out:
        raise ValueError(
            f"no models could be loaded from reference-layout {directory!r}")
    return out


def _maps_from_coordinate_records(coord_recs) -> Dict[str, IndexMap]:
    """One map per feature shard, built from the union of every
    coordinate's record keys on that shard — coordinates sharing a shard
    share one map, so loaded coefficient columns can never disagree."""
    from photon_ml_tpu_torch.data.avro_io import model_record_keys
    keys_by_shard: Dict[str, list] = {}
    for (_, _, shard, _, _), recs in coord_recs:
        keys_by_shard.setdefault(shard, []).extend(model_record_keys(recs))
    return {shard: IndexMap.from_keys(
                [feature_key(n, t) for n, t in keys], add_intercept=True)
            for shard, keys in keys_by_shard.items()}


_REF_MAPS_MEMO: dict = {}


def _reference_dir_stamp(directory: str, entries) -> tuple:
    """On-disk identity of a reference model dir: every part file AND every
    id-info file (sizes + mtimes)."""
    files = [p for _, _, _, _, parts in entries for p in parts]
    for kind, name, _, _, _ in entries:
        files.append(os.path.join(directory, kind, name, "id-info"))
    return tuple((p, os.path.getsize(p), os.stat(p).st_mtime_ns)
                 for p in files)


def _memoized_reference_maps(directory, entries, coord_recs=None):
    """The rebuilt per-shard maps, memoized per on-disk state so a scoring
    run (load_game_model + load_model_index_maps) decodes every part file
    once, not twice.  Only the LIGHT maps are retained — record lists are
    never cached, so a loaded multi-million-entity model is not held
    resident twice."""
    from photon_ml_tpu_torch.data.avro_io import _read_model_records
    stamp = _reference_dir_stamp(directory, entries)
    key = os.path.abspath(directory)
    cached = _REF_MAPS_MEMO.get(key)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    if coord_recs is None:
        coord_recs = [(entry, _read_model_records(entry[4]))
                      for entry in entries]
    maps = _maps_from_coordinate_records(coord_recs)
    _REF_MAPS_MEMO.clear()  # keep at most one directory resident
    _REF_MAPS_MEMO[key] = (stamp, maps)
    return maps


def _reference_layout_index_maps(directory: str) -> Dict[str, IndexMap]:
    return _memoized_reference_maps(directory,
                                    _reference_coordinate_dirs(directory))


def _load_game_model_reference(
    directory: str,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[GameModel, None]:
    """Load a GAME model the Scala reference itself wrote
    (ModelProcessingUtils.scala:136-238).  Without provided index maps the
    feature spaces are rebuilt compactly from the records, exactly like the
    reference's makeFeatureIndexForModel path."""
    from photon_ml_tpu_torch.data.avro_io import (_TASK_BY_CLASS,
                                                  glm_arrays_from_record,
                                                  re_arrays_from_records)
    put = _putter(device, dtype)
    meta_task = None
    meta_p = os.path.join(directory, "model-metadata.json")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            raw = json.load(f)
        model_type = str(raw.get("modelType", "NONE"))
        if model_type not in _REFERENCE_TASKS:
            raise ValueError(f"unknown reference modelType {model_type!r}")
        meta_task = _REFERENCE_TASKS[model_type]
    from photon_ml_tpu_torch.data.avro_io import _read_model_records
    entries = _reference_coordinate_dirs(directory)
    coord_recs = [(entry, _read_model_records(entry[4]))
                  for entry in entries]
    if index_maps is None:
        # prefer maps saved next to the model (our own reference-layout
        # writer records them so L1-zeroed coefficients keep their columns);
        # a directory the Scala reference wrote has none -> rebuild compactly
        saved = os.path.join(directory, "index-maps")
        index_maps = (IndexMapCollection.load(saved).shards
                      if os.path.isdir(saved)
                      else _memoized_reference_maps(directory, entries,
                                                    coord_recs))
    coords = {}
    tasks = set()
    for (kind, name, shard, re_type, _), recs in coord_recs:
        imap = index_maps[shard]
        if kind == "fixed-effect":
            if len(recs) != 1:
                raise ValueError(
                    f"{directory}/{kind}/{name}: expected one fixed-effect "
                    f"record, got {len(recs)}")
            _, task, means, variances = glm_arrays_from_record(recs[0], imap)
            coords[name] = (task, "fe", shard, means, variances)
        else:
            e_ids, means, variances = re_arrays_from_records(recs, imap)
            task = (_TASK_BY_CLASS.get(recs[0].get("modelClass") or "", None)
                    if recs else None)  # empty Spark partitions are normal
            coords[name] = (task, "re", shard, (e_ids, means, variances),
                            re_type)
        if task:
            tasks.add(task)
    task_type = meta_task or (tasks.pop() if len(tasks) == 1 else None)
    if task_type is None:
        raise ValueError(
            f"cannot determine task type for {directory!r}: no modelType "
            "metadata and no modelClass on the records")
    out = {}
    for name, info in coords.items():
        if info[1] == "fe":
            _, _, shard, means, variances = info
            coeffs = Coefficients(
                put(means),
                None if variances is None else put(variances))
            out[name] = FixedEffectModel(model_for_task(task_type, coeffs),
                                         shard)
        else:
            _, _, shard, (e_ids, means, variances), re_type = info
            out[name] = RandomEffectModel(
                random_effect_type=re_type, feature_shard=shard,
                task_type=task_type, coefficients=put(means),
                entity_ids=np.asarray(e_ids, dtype=object),
                projection=None, global_dim=means.shape[1],
                variances=(None if variances is None
                           else put(variances)))
    return GameModel(out, task_type), None


def save_game_model_reference_layout(
    model: GameModel,
    directory: str,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    num_re_partitions: int = 1,
) -> None:
    """Write a GAME model in the Scala reference's OWN directory layout
    (ModelProcessingUtils.scala:71-135), so actual photon-ml can score or
    warm-start from it.  Factored/random-projection random effects
    materialize to original space; matrix-factorization coordinates are
    rejected (the reference stores MF models separately, scala:450-516)."""
    from photon_ml_tpu_torch.data.avro_io import (write_glm_avro,
                                            write_random_effect_avro)
    os.makedirs(directory, exist_ok=True)
    if index_maps:
        # Avro records drop zero coefficients (L1 makes exact zeros
        # common), so without the maps a reload rebuilds a shrunken,
        # shifted feature space.  The extra index-maps/ dir is ours; the
        # Scala reference ignores unknown directories.
        IndexMapCollection(dict(index_maps)).save(
            os.path.join(directory, "index-maps"))
    atomic_write_json(
        os.path.join(directory, "model-metadata.json"),
        {"modelType": {v: k for k, v in _REFERENCE_TASKS.items()
                       if v}.get(model.task_type, "NONE"),
         "modelName": os.path.basename(directory.rstrip("/"))})
    for name, m in model.coordinates.items():
        if isinstance(m, MatrixFactorizationModel):
            raise ValueError(
                "matrix-factorization coordinates have no reference GAME "
                "model layout (saved separately in the reference, "
                "ModelProcessingUtils.scala:450-516)")
        if isinstance(m, FactoredRandomEffectModel):
            m = m.to_random_effect_model()
        if isinstance(m, FixedEffectModel):
            sub = os.path.join(directory, "fixed-effect", name)
            coeff_dir = os.path.join(sub, "coefficients")
            os.makedirs(coeff_dir, exist_ok=True)
            atomic_write_text(os.path.join(sub, "id-info"),
                              m.feature_shard + "\n")
            means = _host(m.glm.coefficients.means)
            imap = (index_maps or {}).get(m.feature_shard) or \
                _shard_index_map(None, m.feature_shard, len(means))
            var = m.glm.coefficients.variances
            # modelId is the literal "fixed-effect", matching the Scala
            # writer (saveModelToHDFS passes AvroConstants.FIXED_EFFECT)
            write_glm_avro(
                os.path.join(coeff_dir, "part-00000.avro"), "fixed-effect",
                model.task_type, means, imap,
                None if var is None else _host(var))
        elif isinstance(m, RandomEffectModel):
            if m.projection_matrix is not None:
                m = RandomEffectModel(
                    random_effect_type=m.random_effect_type,
                    feature_shard=m.feature_shard, task_type=m.task_type,
                    coefficients=m.global_coefficients(),
                    entity_ids=m.entity_ids, projection=None,
                    global_dim=m.global_dim)
            sub = os.path.join(directory, "random-effect", name)
            coeff_dir = os.path.join(sub, "coefficients")
            os.makedirs(coeff_dir, exist_ok=True)
            atomic_write_text(os.path.join(sub, "id-info"),
                              m.random_effect_type + "\n"
                              + m.feature_shard + "\n")
            imap = (index_maps or {}).get(m.feature_shard) or \
                _shard_index_map(None, m.feature_shard, m.global_dim)
            E = m.num_entities
            n_parts = max(1, min(num_re_partitions, E))
            bounds = np.linspace(0, E, n_parts + 1).astype(int)
            for p in range(n_parts):
                lo, hi = int(bounds[p]), int(bounds[p + 1])
                write_random_effect_avro(
                    os.path.join(coeff_dir, f"part-{p:05d}.avro"),
                    m.task_type, _host(m.entity_ids)[lo:hi],
                    _host(m.coefficients)[lo:hi], imap,
                    projection=(None if m.projection is None
                                else m.projection[lo:hi]),
                    variances=(None if m.variances is None
                               else _host(m.variances)[lo:hi]))
            # Spark leaves a _SUCCESS marker; the loader must skip it
            write_marker(os.path.join(coeff_dir, "_SUCCESS"))
        else:
            raise TypeError(f"unknown coordinate model type {type(m)}")


def _load_game_model_avro(directory, meta, device=None,
                          dtype: torch.dtype = torch.float32):
    from photon_ml_tpu_torch.data.avro_io import (
        read_glm_avro, read_latent_factors_avro, read_random_effect_avro,
    )
    put = _putter(device, dtype)
    task = meta["task_type"]
    saved_maps = load_model_index_maps(directory) or {}
    coords = {}
    for name, info in meta["coordinates"].items():
        if info["kind"] == "fixed_effect":
            _, _, means, variances, _ = read_glm_avro(
                os.path.join(directory, "fixed-effect", name,
                             "coefficients.avro"),
                saved_maps.get(info["feature_shard"]))
            coeffs = Coefficients(
                put(means),
                None if variances is None else put(variances))
            coords[name] = FixedEffectModel(model_for_task(task, coeffs),
                                            info["feature_shard"])
        elif info["kind"] == "random_effect":
            e_ids, means, variances, imap = read_random_effect_avro(
                os.path.join(directory, "random-effect", name,
                             "coefficients.avro"),
                saved_maps.get(info["feature_shard"]))
            coords[name] = RandomEffectModel(
                random_effect_type=info["random_effect_type"],
                feature_shard=info["feature_shard"], task_type=task,
                coefficients=put(means),
                entity_ids=np.asarray(e_ids, dtype=object),
                projection=None, global_dim=imap.size,
                variances=(None if variances is None
                           else put(variances)))
        elif info["kind"] == "matrix_factorization":
            sub = os.path.join(directory, "matrix-factorization", name)
            row_ids, row_f = read_latent_factors_avro(
                os.path.join(sub, "row-factors.avro"))
            col_ids, col_f = read_latent_factors_avro(
                os.path.join(sub, "col-factors.avro"))
            coords[name] = MatrixFactorizationModel(
                row_effect_type=info["row_effect_type"],
                col_effect_type=info["col_effect_type"],
                row_factors=put(row_f),
                row_ids=np.asarray(row_ids, dtype=object),
                col_factors=put(col_f),
                col_ids=np.asarray(col_ids, dtype=object),
                task_type=info.get("task_type", "none"))
        else:
            raise ValueError(
                f"unknown avro coordinate kind {info['kind']!r}")
    config = (GameTrainingConfig.from_dict(meta["config"])
              if meta.get("config") else None)
    return GameModel(coords, task), config


def load_game_model(directory: str, device=None,
                    dtype: torch.dtype = torch.float32,
                    ) -> Tuple[GameModel, Optional[GameTrainingConfig]]:
    """reference: ModelProcessingUtils.loadGameModelFromHDFS (scala:136-238).

    Accepts the npz and Avro layouts of either package AND a model
    directory the Scala reference itself wrote (part-*.avro partition
    files + the reference's own model-metadata.json, or no metadata at all
    for pre-metadata models).  Coefficients land on `device` (None means
    cuda) in `dtype`.  The npz files hold object arrays (entity ids,
    feature keys), read with `allow_pickle=True` as the JAX package reads
    them: load only model directories you trust.

    `model.load` is a fault-injection site (utils/faults.py): chaos runs
    inject read failures here to prove resume falls back cleanly."""
    from photon_ml_tpu_torch.utils import faults
    faults.fire("model.load", directory=os.path.basename(directory.rstrip("/")))
    put = _putter(device, dtype)
    meta_p = os.path.join(directory, "model-metadata.json")
    if not os.path.exists(meta_p):
        if _is_reference_layout(directory):
            return _load_game_model_reference(directory, device=device,
                                              dtype=dtype)
        raise FileNotFoundError(meta_p)
    with open(meta_p) as f:
        meta = json.load(f)
    if "modelType" in meta and "coordinates" not in meta:
        return _load_game_model_reference(directory, device=device, dtype=dtype)
    if meta.get("storage_format") == "avro":
        return _load_game_model_avro(directory, meta, device, dtype)
    task = meta["task_type"]
    coords = {}
    for name, info in meta["coordinates"].items():
        if info["kind"] == "fixed_effect":
            z = np.load(os.path.join(directory, "fixed-effect", name,
                                     "coefficients.npz"), allow_pickle=True)
            coeffs = Coefficients(
                put(z["means"]),
                put(z["variances"]) if "variances" in z else None)
            coords[name] = FixedEffectModel(model_for_task(task, coeffs),
                                            info["feature_shard"])
        elif info["kind"] == "factored_random_effect":
            z = np.load(os.path.join(directory, "factored-random-effect", name,
                                     "coefficients.npz"), allow_pickle=True)
            coords[name] = FactoredRandomEffectModel(
                random_effect_type=info["random_effect_type"],
                feature_shard=info["feature_shard"],
                task_type=task,
                latent_coefficients=put(z["latent_coefficients"]),
                projection=put(z["projection"]),
                entity_ids=z["entity_ids"],
                global_dim=int(z["global_dim"]))
        elif info["kind"] == "matrix_factorization":
            z = np.load(os.path.join(directory, "matrix-factorization", name,
                                     "factors.npz"), allow_pickle=True)
            coords[name] = MatrixFactorizationModel(
                row_effect_type=info["row_effect_type"],
                col_effect_type=info["col_effect_type"],
                row_factors=put(z["row_factors"]), row_ids=z["row_ids"],
                col_factors=put(z["col_factors"]), col_ids=z["col_ids"],
                task_type=info.get("task_type", "none"))
        else:
            z = np.load(os.path.join(directory, "random-effect", name,
                                     "coefficients.npz"), allow_pickle=True)
            coords[name] = RandomEffectModel(
                random_effect_type=info["random_effect_type"],
                feature_shard=info["feature_shard"],
                task_type=task,
                coefficients=put(z["coefficients"]),
                entity_ids=z["entity_ids"],
                projection=z["projection"] if "projection" in z else None,
                global_dim=int(z["global_dim"]),
                variances=put(z["variances"]) if "variances" in z else None,
                projection_matrix=(z["projection_matrix"]
                                   if "projection_matrix" in z else None))
    config = (GameTrainingConfig.from_dict(meta["config"])
              if meta.get("config") else None)
    return GameModel(coords, task), config


def _remap_columns(arr: np.ndarray, source: IndexMap,
                   target: IndexMap) -> np.ndarray:
    """Re-key the last axis from `source`'s column order to `target`'s;
    features absent from the source become 0."""
    idx = np.asarray([source.key_to_index.get(str(k), -1)
                      for k in target.index_to_key])
    gathered = _host(arr)[..., np.maximum(idx, 0)]
    return np.where(idx >= 0, gathered, 0.0)


def align_game_model_to_dataset(model: GameModel,
                                model_maps: Optional[Dict[str, IndexMap]],
                                dataset) -> GameModel:
    """Make a loaded model usable as a warm start for `dataset`: remap each
    coordinate's coefficients into the dataset's feature spaces.

    A reference-layout model rebuilds a COMPACT feature space from its
    records (zero coefficients are not stored), and a different data slice
    scans a different vocabulary — warm-starting raw coefficients would
    either shape-error or silently bind them to the wrong features.  With
    index maps on both sides, columns re-key by (name, term) and missing
    features start at 0; without maps, the dimensions must match exactly.
    Projected/factored/matrix-factorization coordinates cannot re-key
    (their local spaces don't carry global feature names) and require
    identical dimensions."""
    import dataclasses
    model_maps = model_maps or {}
    out = {}
    for name, m in model.coordinates.items():
        if isinstance(m, FixedEffectModel):
            shard = m.feature_shard
            if shard not in dataset.feature_shards:
                raise ValueError(
                    f"warm-start coordinate {name!r} scores feature shard "
                    f"{shard!r}, which the training data does not carry")
            want = dataset.feature_shards[shard].shape[1]
            means = _host(m.glm.coefficients.means)
            mm, tm = model_maps.get(shard), dataset.index_maps.get(shard)
            if mm is not None and tm is not None and \
                    list(mm.index_to_key) != list(tm.index_to_key):
                var = m.glm.coefficients.variances
                ref = m.glm.coefficients.means
                coeffs = Coefficients(
                    _like(_remap_columns(means, mm, tm), ref),
                    None if var is None else
                    _like(_remap_columns(_host(var), mm, tm), ref))
                m = FixedEffectModel(
                    m.glm.with_coefficients(coeffs), shard)
            elif len(means) != want:
                raise ValueError(
                    f"warm-start coordinate {name!r} has {len(means)} "
                    f"coefficients but shard {shard!r} is {want} wide, and "
                    "no index maps exist on both sides to re-key them by "
                    "feature name")
            out[name] = m
            continue
        if isinstance(m, RandomEffectModel) and m.projection is None \
                and m.projection_matrix is None:
            shard = m.feature_shard
            want = dataset.feature_shards.get(shard)
            want = None if want is None else want.shape[1]
            coefs = _host(m.coefficients)
            mm, tm = model_maps.get(shard), dataset.index_maps.get(shard)
            if mm is not None and tm is not None and \
                    list(mm.index_to_key) != list(tm.index_to_key):
                ref = m.coefficients
                m = dataclasses.replace(
                    m, coefficients=_like(_remap_columns(coefs, mm, tm), ref),
                    variances=None if m.variances is None else
                    _like(_remap_columns(_host(m.variances), mm, tm), ref),
                    global_dim=tm.size)
            elif want is not None and coefs.shape[1] != want:
                raise ValueError(
                    f"warm-start coordinate {name!r} has width "
                    f"{coefs.shape[1]} but shard {shard!r} is {want} wide, "
                    "and no index maps exist on both sides to re-key")
            out[name] = m
            continue
        # projected / factored / MF coordinates: no global names to re-key
        shard = getattr(m, "feature_shard", None)
        if shard is not None and shard in dataset.feature_shards:
            want = dataset.feature_shards[shard].shape[1]
            have = getattr(m, "global_dim", want)
            if have != want:
                raise ValueError(
                    f"warm-start coordinate {name!r} ({type(m).__name__}) "
                    f"lives in a projected space over a {have}-wide shard, "
                    f"but the training shard {shard!r} is {want} wide — "
                    "projected coordinates cannot be re-keyed")
        out[name] = m
    return GameModel(out, model.task_type)


def save_glm(model, directory: str, index_map: Optional[IndexMap] = None,
             extra_metadata: Optional[dict] = None) -> None:
    """Single-GLM save (reference: legacy GLMSuite.writeModelsToHDFS path)."""
    os.makedirs(directory, exist_ok=True)
    arrays = {"means": _host(model.coefficients.means)}
    if model.coefficients.variances is not None:
        arrays["variances"] = _host(model.coefficients.variances)
    if index_map is not None:
        arrays["feature_keys"] = index_map.index_to_key.astype(object)
    np.savez_compressed(os.path.join(directory, "coefficients.npz"), **arrays)
    atomic_write_json(os.path.join(directory, "model-metadata.json"),
                      {"format_version": _FORMAT_VERSION,
                       "task_type": type(model).task_type,
                       **(extra_metadata or {})})


def load_glm(directory: str, device=None, dtype: torch.dtype = torch.float32):
    put = _putter(device, dtype)
    with open(os.path.join(directory, "model-metadata.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(directory, "coefficients.npz"), allow_pickle=True)
    coeffs = Coefficients(put(z["means"]),
                          put(z["variances"]) if "variances" in z else None)
    return model_for_task(meta["task_type"], coeffs), meta


# -- online model deltas ------------------------------------------------------

def save_model_delta(delta, directory: str) -> None:
    """Durable persistence of an online ModelDelta (photon_ml_tpu_torch/
    online): the audit/replication artifact of a row-level delta swap.

    Write discipline matches checkpoints: the npz lands via tmp + fsync +
    atomic replace, metadata via atomic_write_json, and a per-file
    size+sha256 manifest.json is written LAST — at any crash instant the
    directory either verifies complete or is detectably partial
    (load_model_delta refuses the latter)."""
    from photon_ml_tpu_torch.utils.durable import (fsync_dir, fsync_file,
                                                   write_manifest)
    os.makedirs(directory, exist_ok=True)
    npz_path = os.path.join(directory, "delta.npz")
    tmp = npz_path + ".tmp.npz"   # savez appends .npz to unsuffixed paths
    np.savez_compressed(tmp, **delta.to_arrays())
    fsync_file(tmp)
    os.replace(tmp, npz_path)
    fsync_dir(directory)
    atomic_write_json(os.path.join(directory, "delta-metadata.json"), {
        "format_version": _FORMAT_VERSION,
        "base_version": delta.base_version,
        "delta_seq": delta.seq,
        "created_at": delta.created_at,
        "coordinates": {name: cd.num_rows
                        for name, cd in delta.coordinates.items()},
        "num_rows": delta.num_rows,
    })
    write_manifest(directory)


def load_model_delta(directory: str):
    """Load + VERIFY a persisted ModelDelta: the manifest must be present
    and every file must match its recorded size and sha256 (a torn or
    tampered delta must never reach apply_delta).  The delta's arrays stay
    host numpy; apply_delta moves them to the scorer's device."""
    from photon_ml_tpu_torch.online.delta import ModelDelta
    from photon_ml_tpu_torch.utils.durable import file_sha256
    manifest_p = os.path.join(directory, "manifest.json")
    if not os.path.exists(manifest_p):
        raise FileNotFoundError(
            f"no manifest.json in {directory!r} — the delta write did not "
            "complete (or this is not a delta directory)")
    with open(manifest_p) as f:
        manifest = json.load(f)
    for rel, want in manifest.get("files", {}).items():
        p = os.path.join(directory, rel)
        if not os.path.exists(p) or os.path.getsize(p) != want["bytes"] \
                or file_sha256(p) != want["sha256"]:
            raise ValueError(
                f"delta file {rel!r} in {directory!r} does not match its "
                "manifest (size/sha256) — refusing to load a torn or "
                "tampered delta")
    with open(os.path.join(directory, "delta-metadata.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(directory, "delta.npz"), allow_pickle=True)
    return ModelDelta.from_arrays(
        {k: z[k] for k in z.files}, base_version=meta["base_version"],
        seq=meta["delta_seq"], created_at=meta.get("created_at", 0.0))
