"""Merged multi-bag Avro ingest: reference-format records -> GameDataset
(a copy of photon_ml_tpu/data/avro_game.py; host code).

Rebuild of the reference's primary GAME input path:
  - AvroDataReader.readMerged (photon-client/.../data/avro/AvroDataReader.scala:84-200):
    each record carries SEVERAL feature-bag array fields (e.g. "features",
    "userFeatures", "songFeatures"); a {shard -> set(bags)} map merges bags
    into per-coordinate feature shards, each with its own (name, term)
    index map (generated by scanning when not supplied).
  - Sparse assembly (AvroDataReader.scala:332-440): per-record merged
    features resolve through the shard's index map into a sparse vector
    with the intercept appended; duplicate (name, term) pairs within one
    record's shard are an error.
  - Id-tag extraction (GameConverters.getIdTagToValueMapFromRow,
    photon-api/.../data/GameConverters.scala:140-170): an id column is read
    from a top-level record field when present, else from metadataMap[tag];
    a record with neither is an error.

TPU-first design: decode runs through the native block decoder
(data/avro_native.py) into flat typed columns; (name, term) -> column-index
resolution is VECTORIZED — fixed-width byte arrays + np.unique over the
whole corpus's feature occurrences, with Python touching only the
per-shard vocabulary (not the per-occurrence stream).  The result is a
GameDataset in canonical row order: shards dense [n, d] below
`dense_threshold` columns, scipy CSR above it (which downstream becomes
PaddedSparse on device, ops/features.py), and entity id columns interned
to int indices.  No Spark DataFrame, no shuffle: the merge is a segment
concatenation and the "join" is np.repeat/np.unique.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data import avro_native
from photon_ml_tpu_torch.data.avro_codec import read_container, write_container
from photon_ml_tpu_torch.data.avro_io import FEATURE_AVRO
from photon_ml_tpu_torch.data.game_data import (GameDataset, InputColumnNames,
                                          build_game_dataset)
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key


@dataclasses.dataclass
class GameAvroResult:
    """readMerged output: the dataset plus row-aligned uids (the dataset's
    canonical order IS the row id, but reference ScoringResultAvro carries
    the original uid strings through to scoring output)."""

    dataset: GameDataset
    uids: Optional[List[Optional[str]]]


def read_game_examples(
    paths: str | Iterable[str],
    feature_shard_map: Dict[str, Sequence[str]],
    id_columns: Sequence[str] = (),
    index_maps: Optional[Dict[str, IndexMap]] = None,
    columns: InputColumnNames = InputColumnNames(),
    require_response: bool = True,
    dense_threshold: int = 4096,
    feature_dtype=np.float32,
    entity_vocabs: Optional[Dict[str, np.ndarray]] = None,
) -> GameAvroResult:
    """Avro file(s) with multiple feature bags -> multi-shard GameDataset.

    `feature_shard_map` maps shard name -> feature-bag field names to merge
    (reference featureColumnMap, e.g. {"userFeatures": ["profileFeatures",
    "titleFeatures"]}).  `id_columns` are the random-effect id tags to
    extract (top-level field or metadataMap key).  Shards with more than
    `dense_threshold` features assemble as scipy CSR (the wide regime);
    smaller ones densify.  `require_response=False` fills NaN when no
    response column exists (scoring input, reference isResponseRequired).
    `index_maps` / `entity_vocabs` pin a validation or scoring read to the
    TRAINING dataset's feature and entity spaces (unseen entities -> -1)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    paths = [str(p) for p in paths]
    if not paths:
        raise ValueError("no input paths given")
    if not feature_shard_map:
        raise ValueError("feature_shard_map must name at least one shard")
    if index_maps is not None:
        # pinned reads are all-or-nothing: scanning a fresh vocabulary for
        # just the uncovered shard would silently misalign its columns with
        # whatever model/training space the caller is pinning to
        uncovered = sorted(set(feature_shard_map) - set(index_maps))
        if uncovered:
            raise ValueError(
                f"index_maps pins this read to an existing feature space "
                f"but covers no shard(s) {uncovered} from the feature shard "
                "map — columns for those shards would silently misalign")

    cols_list = [avro_native.read_columnar(p, decode_maps=True)
                 for p in paths]
    native = all(c is not None for c in cols_list)
    avro_native.note_route(native, len(paths))
    if not native:
        return _read_game_python(paths, feature_shard_map, id_columns,
                                 index_maps, columns, require_response,
                                 dense_threshold, feature_dtype,
                                 entity_vocabs)

    # ---- scalar columns -----------------------------------------------------
    n_per_file = []
    for c in cols_list:
        name, vals = _find_response(c, columns, allow_missing=True)
        n_per_file.append(len(vals) if name is not None
                          else _infer_rows(c, feature_shard_map))

    response = _gather_response(cols_list, n_per_file, columns,
                                require_response)
    weights = _gather_optional(cols_list, n_per_file, columns.weight, 1.0)
    offsets = _gather_optional(cols_list, n_per_file, columns.offset, 0.0)
    uids = _gather_uids(cols_list, columns.uid)

    # ---- id columns ---------------------------------------------------------
    entity_ids = {tag: _gather_id_column(cols_list, n_per_file, tag, columns)
                  for tag in id_columns}

    # ---- feature shards -----------------------------------------------------
    shards: Dict[str, np.ndarray] = {}
    maps: Dict[str, IndexMap] = {}
    for shard, bags in feature_shard_map.items():
        given = (index_maps or {}).get(shard)
        shards[shard], maps[shard] = _assemble_shard(
            cols_list, n_per_file, shard, list(bags), given,
            dense_threshold, feature_dtype)

    ds = build_game_dataset(
        response, shards, offsets=offsets, weights=weights,
        entity_ids=entity_ids, entity_vocabs=entity_vocabs, index_maps=maps)
    return GameAvroResult(dataset=ds, uids=uids)


# ---------------------------------------------------------------------------
# native columnar helpers
# ---------------------------------------------------------------------------


_DEFAULT_RESPONSE = InputColumnNames().response


def _find_response(cols, columns: InputColumnNames, allow_missing=False):
    """-> (name, values) trying the configured name then 'label'/'response'
    (TrainingExampleAvro uses 'label'; the reference GAME convention is
    'response').  An EXPLICITLY remapped response name never falls back —
    silently training on a different column would hide the user's typo."""
    explicit = columns.response != _DEFAULT_RESPONSE
    candidates = ((columns.response,) if explicit
                  else (columns.response, "label"))
    for name in candidates:
        if name in cols and isinstance(cols[name], np.ndarray):
            return name, cols[name]
    if allow_missing:
        return None, None
    if explicit:
        raise ValueError(
            f"remapped response column {columns.response!r} not found in "
            "the input records")
    raise ValueError(
        f"no response column among {columns.response!r}/'label'/'response'")


def _infer_rows(cols, feature_shard_map) -> int:
    for bags in feature_shard_map.values():
        for bag in bags:
            key = f"{bag}#count"
            if key in cols:
                return len(cols[key])
    raise ValueError("cannot infer record count: no response column and no "
                     "feature-bag count column")


def _gather_response(cols_list, n_per_file, columns, require_response):
    out = []
    for cols, n in zip(cols_list, n_per_file):
        name, vals = _find_response(cols, columns, allow_missing=True)
        if name is None:
            if require_response:
                # allow_missing=False re-raises with the explicit-remap or
                # default-search message as appropriate
                _find_response(cols, columns, allow_missing=False)
            vals = np.full(n, np.nan)
        elif f"{name}#present" in cols:
            present = cols[f"{name}#present"] == 1
            if require_response and not present.all():
                raise ValueError(
                    f"null response at row {int(np.flatnonzero(~present)[0])}"
                    " — training input requires a response for every record")
            vals = np.where(present, vals, np.nan)
        out.append(np.asarray(vals, np.float64))
    return np.concatenate(out)


def _gather_optional(cols_list, n_per_file, name, default):
    """Nullable double column across files; None when absent everywhere."""
    any_present = False
    out = []
    for cols, n_f in zip(cols_list, n_per_file):
        if name in cols and f"{name}#present" in cols:
            present = cols[f"{name}#present"] == 1
            any_present = any_present or bool(present.any())
            out.append(np.where(present, cols[name], default))
        elif name in cols and isinstance(cols[name], np.ndarray):
            any_present = True
            out.append(np.asarray(cols[name], np.float64))
        else:
            out.append(np.full(n_f, default))
    if not any_present:
        return None
    return np.concatenate([np.asarray(a, np.float64) for a in out])


def _gather_uids(cols_list, name):
    if not all(name in c for c in cols_list):
        return None
    # a non-nullable string uid decodes as a plain StrColumn with no
    # #present companion — treat every row as present so the native path
    # keeps uid passthrough parity with the pure-Python fallback (which
    # also passes numeric uids through; those decode as plain ndarrays)
    present = np.concatenate([
        c[f"{name}#present"] if f"{name}#present" in c
        else np.ones(len(c[name]), dtype=np.uint8)
        for c in cols_list])
    if not present.any():
        return None
    vals: List = []
    for c in cols_list:
        col = c[name]
        vals.extend(col.to_list() if isinstance(col, avro_native.StrColumn)
                    else np.asarray(col).tolist())
    return [v if p else None for v, p in zip(vals, present)]


def _gather_id_column(cols_list, n_per_file, tag, columns) -> np.ndarray:
    """Id tag -> [n] string array: top-level field first, else
    metadataMap[tag] (reference: GameConverters.getIdTagToValueMapFromRow)."""
    out = []
    meta = "metadataMap"
    for cols, n_f in zip(cols_list, n_per_file):
        if tag in cols:
            v = cols[tag]
            if isinstance(v, avro_native.StrColumn):
                arr = v.to_str_array()
            else:
                arr = np.asarray(v).astype("U24")
            if f"{tag}#present" in cols and not (cols[f"{tag}#present"] == 1).all():
                raise ValueError(f"id column {tag!r} has null values")
            out.append(arr)
            continue
        kkey, vkey, ckey = f"{meta}.key", f"{meta}.value", f"{meta}#count"
        if kkey not in cols:
            raise ValueError(
                f"cannot find id in either record field {tag!r} or in "
                f"metadataMap (reference: GameConverters id-tag lookup)")
        counts = cols[ckey]
        tag_b = tag.encode()
        key_col = cols[kkey]
        # length pre-filter, then byte-compare only the candidates: the
        # padded gather never sees entries longer than the tag, so one huge
        # metadata key or value elsewhere cannot inflate memory
        cand = np.flatnonzero(key_col.lengths() == len(tag_b))
        cand = cand[key_col.take_bytes(cand) == tag_b]
        entry_row = np.repeat(np.arange(n_f), counts)
        hit_rows = entry_row[cand]
        per_row = np.bincount(hit_rows, minlength=n_f)
        if (per_row == 0).any():
            missing = int(np.flatnonzero(per_row == 0)[0])
            raise ValueError(
                f"cannot find id in either record field {tag!r} or in "
                f"metadataMap with key {tag!r} (first offending row "
                f"{missing})")
        if (per_row > 1).any():
            # keep the first entry per row (maps cannot truly duplicate
            # keys; duplicate tags across map blocks take the first)
            order = np.argsort(hit_rows, kind="stable")
            starts = np.searchsorted(hit_rows[order], np.arange(n_f),
                                     side="left")
            cand = cand[order][starts]
        vals = cols[vkey].take_bytes(cand)
        out.append(np.char.decode(vals, "utf-8"))
    return np.concatenate(out)


def _assemble_shard(cols_list, n_per_file, shard, bags, index_map,
                    dense_threshold, feature_dtype):
    """Merge `bags` across files into one [n, d] shard + its IndexMap."""
    name_cols, term_cols, val_parts, row_parts = [], [], [], []
    row_offset = 0
    for cols, n_f in zip(cols_list, n_per_file):
        for bag in bags:
            ckey = f"{bag}#count"
            if ckey not in cols:
                raise ValueError(
                    f"feature bag {bag!r} (shard {shard!r}) not found in "
                    f"input records")
            counts = np.asarray(cols[ckey])
            name_cols.append(cols[f"{bag}.name"])
            term_cols.append(cols[f"{bag}.term"])
            val_parts.append(np.asarray(cols[f"{bag}.value"]))
            row_parts.append(np.repeat(np.arange(n_f), counts) + row_offset)
        row_offset += n_f
    n = row_offset
    values = np.concatenate(val_parts) if val_parts else np.zeros(0)
    row_idx = (np.concatenate(row_parts) if row_parts
               else np.zeros(0, np.int64))

    # vocabulary + per-occurrence codes in one vectorized pass; Python only
    # ever touches the VOCABULARY (reference: generateIndexMapLoaders scans
    # the corpus with a reduceByKey — here it is length-bucketed np.unique,
    # avro_native.resolve_feature_keys)
    index_map, col_idx = avro_native.resolve_feature_keys(
        name_cols, term_cols, index_map)

    # duplicate (name, term) within one record's merged shard is an error
    # (reference: readFeatureVectorFromRecord duplicateFeatures require)
    if len(row_idx):
        order = np.lexsort((col_idx, row_idx))
        rs, cs = row_idx[order], col_idx[order]
        dup = (rs[1:] == rs[:-1]) & (cs[1:] == cs[:-1]) & (cs[1:] >= 0)
        if dup.any():
            i = int(np.flatnonzero(dup)[0])
            key = index_map.key_of(int(cs[i + 1])).replace(DELIMITER, ".")
            raise ValueError(
                f"duplicate feature {key!r} in shard {shard!r} at row "
                f"{int(rs[i + 1])} (merged bags {bags})")

    d = index_map.size
    valid = col_idx >= 0
    icpt = index_map.intercept_index
    if d <= dense_threshold:
        x = np.zeros((n, d), dtype=feature_dtype)
        x[row_idx[valid], col_idx[valid]] = values[valid]
        if icpt is not None:
            x[:, icpt] = 1.0
        return x, index_map
    import scipy.sparse as sp
    rows = row_idx[valid]
    cols_ = col_idx[valid]
    vals = values[valid].astype(feature_dtype)
    if icpt is not None:
        rows = np.concatenate([rows, np.arange(n)])
        cols_ = np.concatenate([cols_, np.full(n, icpt)])
        vals = np.concatenate([vals, np.ones(n, feature_dtype)])
    return (sp.coo_matrix((vals, (rows, cols_)), shape=(n, d)).tocsr(),
            index_map)


# ---------------------------------------------------------------------------
# pure-Python fallback (native lib unavailable / unsupported schema shape)
# ---------------------------------------------------------------------------


def _read_game_python(paths, feature_shard_map, id_columns, index_maps,
                      columns, require_response, dense_threshold,
                      feature_dtype, entity_vocabs=None) -> GameAvroResult:
    records = []
    for p in paths:
        records.extend(read_container(p))
    n = len(records)

    explicit = columns.response != _DEFAULT_RESPONSE
    resp_name = None
    if records:
        candidates = ((columns.response,) if explicit
                      else (columns.response, "label"))
        for cand in candidates:
            if cand in records[0]:
                resp_name = cand
                break
    if resp_name is None and require_response:
        if explicit:
            raise ValueError(
                f"remapped response column {columns.response!r} not found "
                "in the input records")
        raise ValueError(
            f"no response column among {columns.response!r}/'label'/'response'")
    if require_response and resp_name is not None:
        for i, rec in enumerate(records):
            if rec.get(resp_name) is None:
                raise ValueError(
                    f"null response at row {i} — training input requires a "
                    "response for every record")
    response = np.asarray(
        [np.nan if resp_name is None or rec.get(resp_name) is None
         else float(rec[resp_name]) for rec in records])

    def optional(name, default):
        present = [rec.get(name) for rec in records]
        if all(v is None for v in present):
            return None
        return np.asarray([default if v is None else float(v)
                           for v in present])

    weights = optional(columns.weight, 1.0)
    offsets = optional(columns.offset, 0.0)
    uids = [rec.get(columns.uid) for rec in records]
    if all(u is None for u in uids):
        uids = None

    entity_ids = {}
    for tag in id_columns:
        vals = []
        for i, rec in enumerate(records):
            v = rec.get(tag)
            if v is None:
                v = (rec.get("metadataMap") or {}).get(tag)
            if v is None:
                raise ValueError(
                    f"cannot find id in either record field {tag!r} or in "
                    f"metadataMap with key {tag!r} (first offending row {i})")
            vals.append(str(v))
        entity_ids[tag] = np.asarray(vals)

    shards, maps = {}, {}
    for shard, bags in feature_shard_map.items():
        imap = (index_maps or {}).get(shard)
        if imap is None:
            keys = set()
            for rec in records:
                for bag in bags:
                    for f in rec.get(bag) or ():
                        keys.add(feature_key(f["name"], f["term"]))
            imap = IndexMap.from_keys(sorted(keys), add_intercept=True)
        rows_l, cols_l, vals_l = [], [], []
        for i, rec in enumerate(records):
            seen = {}
            for bag in bags:
                for f in rec.get(bag) or ():
                    j = imap.index_of(f["name"], f["term"])
                    if j in seen and j >= 0:
                        raise ValueError(
                            f"duplicate feature {f['name']}.{f['term']!r} in "
                            f"shard {shard!r} at row {i} (merged bags "
                            f"{list(bags)})")
                    seen[j] = True
                    if j >= 0:
                        rows_l.append(i); cols_l.append(j)
                        vals_l.append(f["value"])
        icpt = imap.intercept_index
        d = imap.size
        if d <= dense_threshold:
            x = np.zeros((n, d), dtype=feature_dtype)
            x[rows_l, cols_l] = vals_l
            if icpt is not None:
                x[:, icpt] = 1.0
        else:
            import scipy.sparse as sp
            rows_a = np.asarray(rows_l + list(range(n)) if icpt is not None
                                else rows_l)
            cols_a = np.asarray(cols_l + [icpt] * n if icpt is not None
                                else cols_l)
            vals_a = np.asarray(vals_l + [1.0] * n if icpt is not None
                                else vals_l, dtype=feature_dtype)
            x = sp.coo_matrix((vals_a, (rows_a, cols_a)), shape=(n, d)).tocsr()
        shards[shard] = x
        maps[shard] = imap

    ds = build_game_dataset(response, shards, offsets=offsets,
                            weights=weights, entity_ids=entity_ids,
                            entity_vocabs=entity_vocabs, index_maps=maps)
    return GameAvroResult(dataset=ds, uids=uids)


# ---------------------------------------------------------------------------
# writer (tests / interchange fixtures; reference records are produced by
# upstream ETL — TrainingExampleAvro-shaped with extra bag and id fields)
# ---------------------------------------------------------------------------


def game_example_schema(bags: Sequence[str], id_columns: Sequence[str],
                        response_column: str = "response") -> dict:
    """Record schema with one FeatureAvro array per bag + string id fields."""
    feature_avro = dict(FEATURE_AVRO)
    fields = [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": response_column, "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ]
    for tag in id_columns:
        fields.append({"name": tag, "type": "string"})
    for i, bag in enumerate(bags):
        items = feature_avro if i == 0 else "FeatureAvro"
        fields.append({"name": bag,
                       "type": {"type": "array", "items": items}})
    return {"name": "GameTrainingExampleAvro",
            "namespace": "com.linkedin.photon.avro.generated",
            "type": "record", "fields": fields}


def write_game_examples(
    path: str,
    response: np.ndarray,
    bags: Dict[str, Tuple[np.ndarray, IndexMap]],
    id_values: Optional[Dict[str, np.ndarray]] = None,
    weights: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    uids: Optional[Sequence[str]] = None,
    metadata: Optional[Sequence[Optional[Dict[str, str]]]] = None,
    response_column: str = "response",
) -> None:
    """Multi-bag GAME records -> one Avro container file.

    `bags` maps bag field name -> (dense [n, d] matrix or scipy matrix,
    IndexMap); zero values and the intercept column are skipped on write
    (they are reconstructed on read)."""
    import scipy.sparse as sp
    id_values = id_values or {}
    bag_names = list(bags)
    schema = game_example_schema(bag_names, list(id_values),
                                 response_column=response_column)
    n = len(response)
    csr = {b: (m.tocsr() if sp.issparse(m) else None)
           for b, (m, _) in bags.items()}

    def bag_features(bag, i):
        mat, imap = bags[bag]
        icpt = imap.intercept_index
        out = []
        if csr[bag] is not None:
            row = csr[bag][i]
            idxs, vals = row.indices, row.data
        else:
            row = np.asarray(mat[i])
            idxs = np.nonzero(row)[0]
            vals = row[idxs]
        for j, v in zip(idxs, vals):
            if icpt is not None and int(j) == icpt:
                continue
            name, term = imap.name_term(int(j))
            out.append({"name": name, "term": term, "value": float(v)})
        return out

    def gen():
        for i in range(n):
            rec = {"uid": None if uids is None else uids[i],
                   response_column: float(response[i]),
                   "weight": None if weights is None else float(weights[i]),
                   "offset": None if offsets is None else float(offsets[i]),
                   "metadataMap": None if metadata is None else metadata[i]}
            for tag, vals in id_values.items():
                rec[tag] = str(vals[i])
            for bag in bag_names:
                rec[bag] = bag_features(bag, i)
            yield rec

    write_container(path, schema, gen())
