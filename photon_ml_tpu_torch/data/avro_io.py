"""Reference-compatible Avro I/O: training data, models, scores
(a copy of photon_ml_tpu/data/avro_io.py; host code).

Schema-compatible with the reference's photon-avro-schemas
(photon-avro-schemas/src/main/avro/*.avsc) so data and models interchange
with the Spark implementation:
  - TrainingExampleAvro + FeatureAvro  (read path of AvroDataReader,
    photon-client/.../data/avro/AvroDataReader.scala:53-451)
  - BayesianLinearModelAvro + NameTermValueAvro  (model save/load of
    ModelProcessingUtils.scala:58-669)
  - ScoringResultAvro  (ScoreProcessingUtils.scala)
  - LatentFactorAvro   (matrix factorization save/load)

The reference reads feature bags per shard and merges them
(AvroDataReader.readMerged); here one bag per file is read into a dense
[n, d] shard via an IndexMap (sparse BCOO assembly is a dataset-build
option at the call site).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.avro_codec import read_container, write_container
from photon_ml_tpu_torch.data.index_map import IndexMap, build_index_map

_NS = "com.linkedin.photon.avro.generated"

FEATURE_AVRO = {"name": "FeatureAvro", "namespace": _NS, "type": "record",
                "fields": [{"name": "name", "type": "string"},
                           {"name": "term", "type": "string"},
                           {"name": "value", "type": "double"}]}

TRAINING_EXAMPLE_AVRO = {
    "name": "TrainingExampleAvro", "namespace": _NS, "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ]}

NAME_TERM_VALUE_AVRO = {"name": "NameTermValueAvro", "namespace": _NS,
                        "type": "record",
                        "fields": [{"name": "name", "type": "string"},
                                   {"name": "term", "type": "string"},
                                   {"name": "value", "type": "double"}]}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "name": "BayesianLinearModelAvro", "namespace": _NS, "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ]}

SCORING_RESULT_AVRO = {
    "name": "ScoringResultAvro", "namespace": _NS, "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ]}

LATENT_FACTOR_AVRO = {
    "name": "LatentFactorAvro", "namespace": _NS, "type": "record",
    "fields": [{"name": "effectId", "type": "string"},
               {"name": "latentFactor",
                "type": {"type": "array", "items": "double"}}]}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "name": "FeatureSummarizationResultAvro", "namespace": _NS,
    "type": "record",
    "fields": [{"name": "featureName", "type": "string"},
               {"name": "featureTerm", "type": "string"},
               {"name": "metrics",
                "type": {"type": "map", "values": "double"}}]}


# -- training data -----------------------------------------------------------


def write_training_examples(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    index_map: IndexMap,
    weights: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    uids: Optional[List[str]] = None,
    metadata: Optional[List[Dict[str, str]]] = None,
) -> None:
    """Dense [n, d] (intercept column skipped) -> TrainingExampleAvro file."""
    intercept = index_map.intercept_index

    def gen():
        for i in range(x.shape[0]):
            feats = []
            row = x[i]
            for j in np.nonzero(row)[0]:
                if intercept is not None and j == intercept:
                    continue
                name, term = index_map.name_term(int(j))
                feats.append({"name": name, "term": term, "value": float(row[j])})
            yield {"uid": uids[i] if uids else None,
                   "label": float(y[i]), "features": feats,
                   "metadataMap": metadata[i] if metadata else None,
                   "weight": None if weights is None else float(weights[i]),
                   "offset": None if offsets is None else float(offsets[i])}

    write_container(path, TRAINING_EXAMPLE_AVRO, gen())


def _read_training_examples_native(paths, index_map):
    """Columnar fast path over the native block decoder; None -> fall back."""
    from photon_ml_tpu_torch.data import avro_native
    required = ("label", "features#count", "features.name", "features.term",
                "features.value", "uid#present", "uid", "weight#present",
                "weight", "offset#present", "offset")
    cols_list = []
    for p in paths:
        cols = avro_native.read_columnar(p)
        if cols is None or any(k not in cols for k in required):
            # unsupported schema shape OR a schema variant missing optional
            # fields -> pure-Python path (which tolerates absent fields)
            return None
        cols_list.append(cols)
    avro_native.note_route(True, len(paths))

    y = np.concatenate([c["label"] for c in cols_list])
    n = len(y)
    counts = np.concatenate([c["features#count"] for c in cols_list])
    values = np.concatenate([c["features.value"] for c in cols_list])
    # vectorized (name, term) -> index resolution; Python touches only the
    # VOCABULARY, never the occurrence stream (avro_native.py helper)
    from photon_ml_tpu_torch.data.avro_native import resolve_feature_keys
    index_map, col_idx = resolve_feature_keys(
        [c["features.name"] for c in cols_list],
        [c["features.term"] for c in cols_list], index_map)
    row_idx = np.repeat(np.arange(n), counts)

    x = np.zeros((n, index_map.size))
    valid = col_idx >= 0
    x[row_idx[valid], col_idx[valid]] = values[valid]
    if index_map.intercept_index is not None:
        x[:, index_map.intercept_index] = 1.0

    def opt_f64(key, default):
        present = np.concatenate([c[f"{key}#present"] for c in cols_list])
        vals = np.concatenate([c[key] for c in cols_list])
        return bool(present.any()), np.where(present == 1, vals, default)

    any_w, weights = opt_f64("weight", 1.0)
    any_o, offsets = opt_f64("offset", 0.0)
    uid_present = np.concatenate([c["uid#present"] for c in cols_list])
    uid_strs: List[str] = []
    for c in cols_list:
        uid_strs.extend(c["uid"].to_list())
    uids = [s if p else None for s, p in zip(uid_strs, uid_present)]
    return (x, y, weights if any_w else None, offsets if any_o else None,
            uids, index_map)


def read_training_examples(
    paths: str | Iterable[str],
    index_map: Optional[IndexMap] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
           List[Optional[str]], IndexMap]:
    """TrainingExampleAvro file(s) -> (x, y, weights, offsets, uids, index_map).

    Two-pass like the reference FeatureIndexingJob + AvroDataReader: build
    the (name, term) index map first (unless given), then fill the dense
    matrix with the intercept column appended last.  Decode runs through the
    native block decoder (data/avro_native.py) when available, falling back
    to the pure-Python codec."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    paths = list(paths)
    fast = _read_training_examples_native(paths, index_map)
    if fast is not None:
        return fast
    from photon_ml_tpu_torch.data import avro_native
    avro_native.note_route(False, len(paths))
    if index_map is None:
        names = []
        for p in paths:
            for rec in read_container(p):
                names.extend((f["name"], f["term"]) for f in rec["features"])
        index_map = build_index_map(names, add_intercept=True)

    rows = []
    for p in paths:
        rows.extend(read_container(p))
    n, d = len(rows), index_map.size
    x = np.zeros((n, d))
    y = np.zeros(n)
    weights = np.ones(n)
    offsets = np.zeros(n)
    any_w = any_o = False
    uids: List[Optional[str]] = []
    intercept = index_map.intercept_index
    for i, rec in enumerate(rows):
        y[i] = rec["label"]
        uids.append(rec.get("uid"))
        if rec.get("weight") is not None:
            weights[i] = rec["weight"]; any_w = True
        if rec.get("offset") is not None:
            offsets[i] = rec["offset"]; any_o = True
        for f in rec["features"]:
            j = index_map.index_of(f["name"], f["term"])
            if j >= 0:
                x[i, j] = f["value"]
        if intercept is not None:
            x[i, intercept] = 1.0
    return (x, y, weights if any_w else None, offsets if any_o else None,
            uids, index_map)


# -- models ------------------------------------------------------------------

_MODEL_CLASS = {
    "logistic_regression":
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    "linear_regression":
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    "poisson_regression":
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    "smoothed_hinge_loss_linear_svm":
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
_TASK_BY_CLASS = {v: k for k, v in _MODEL_CLASS.items()}


def write_glm_avro(path: str, model_id: str, task_type: str,
                   means: np.ndarray, index_map: IndexMap,
                   variances: Optional[np.ndarray] = None) -> None:
    """One GLM -> BayesianLinearModelAvro record (reference:
    ModelProcessingUtils + AvroUtils.convertGLMModelToBayesianLinearModelAvro)."""
    def ntv(vec):
        out = []
        for j in np.nonzero(np.asarray(vec))[0]:
            name, term = index_map.name_term(int(j))
            out.append({"name": name, "term": term, "value": float(vec[j])})
        return out

    rec = {"modelId": model_id, "modelClass": _MODEL_CLASS.get(task_type),
           "means": ntv(means),
           "variances": None if variances is None else ntv(variances),
           "lossFunction": None}
    write_container(path, BAYESIAN_LINEAR_MODEL_AVRO, [rec])


def _read_model_records(path_or_paths):
    """BayesianLinearModelAvro records from one container file or, for the
    reference's partitioned layout, a list of part files concatenated in
    order."""
    if isinstance(path_or_paths, (list, tuple)):
        recs = []
        for p in path_or_paths:
            recs.extend(read_container(p))
        return recs
    return list(read_container(path_or_paths))


def model_record_keys(recs) -> List[Tuple[str, str]]:
    """All (name, term) feature keys appearing in a batch of
    BayesianLinearModelAvro records (means + variances)."""
    keys = []
    for rec in recs:
        keys.extend((f["name"], f["term"]) for f in rec["means"])
        keys.extend((f["name"], f["term"])
                    for f in rec.get("variances") or ())
    return keys


def glm_arrays_from_record(rec, index_map: IndexMap
                           ) -> Tuple[str, Optional[str], np.ndarray,
                                      Optional[np.ndarray]]:
    """One BayesianLinearModelAvro record -> (model_id, task, means,
    variances) dense in `index_map`'s column order."""
    means = np.zeros(index_map.size)
    for f in rec["means"]:
        j = index_map.index_of(f["name"], f["term"])
        if j >= 0:
            means[j] = f["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(index_map.size)
        for f in rec["variances"]:
            j = index_map.index_of(f["name"], f["term"])
            if j >= 0:
                variances[j] = f["value"]
    task = _TASK_BY_CLASS.get(rec.get("modelClass") or "", None)
    return rec["modelId"], task, means, variances


def read_glm_avro(path, index_map: Optional[IndexMap] = None
                  ) -> Tuple[str, Optional[str], np.ndarray,
                             Optional[np.ndarray], IndexMap]:
    """-> (model_id, task_type, means, variances, index_map)."""
    recs = _read_model_records(path)
    if len(recs) != 1:
        raise ValueError(f"{path}: expected 1 model record, got {len(recs)}")
    rec = recs[0]
    if index_map is None:
        # means AND variances: an L1-zeroed coefficient can still carry a
        # nonzero posterior variance entry
        index_map = build_index_map(model_record_keys(recs),
                                    add_intercept=True)
    model_id, task, means, variances = glm_arrays_from_record(rec, index_map)
    return model_id, task, means, variances, index_map


def write_random_effect_avro(path: str, task_type: str,
                             entity_ids, coefficients: np.ndarray,
                             index_map: IndexMap,
                             projection: Optional[np.ndarray] = None,
                             variances: Optional[np.ndarray] = None) -> None:
    """Per-entity GLMs -> one container of BayesianLinearModelAvro records
    (modelId = entity id), always in ORIGINAL feature space — the reference
    stores random-effect models per entity under random-effect/<coord>/
    (ModelProcessingUtils.scala:71-135) with name.term feature keys.

    `coefficients` is [E, d_local]; `projection` (optional, [E, d_local])
    maps local slots to global columns (-1 = padding), exactly the
    RandomEffectModel layout, so projected models export without
    materializing [E, d_global]."""
    coefficients = np.asarray(coefficients)
    variances = None if variances is None else np.asarray(variances)

    def ntv_entity(vec, e):
        out = []
        for j in np.nonzero(vec)[0]:
            g = int(j) if projection is None else int(projection[e, j])
            if g < 0:
                continue
            name, term = index_map.name_term(g)
            out.append({"name": name, "term": term, "value": float(vec[j])})
        return out

    def gen():
        for e, eid in enumerate(np.asarray(entity_ids)):
            yield {"modelId": str(eid),
                   "modelClass": _MODEL_CLASS.get(task_type),
                   "means": ntv_entity(coefficients[e], e),
                   "variances": (None if variances is None
                                 else ntv_entity(variances[e], e)),
                   "lossFunction": None}

    write_container(path, BAYESIAN_LINEAR_MODEL_AVRO, gen())


def read_random_effect_avro(path, index_map: Optional[IndexMap] = None
                            ) -> Tuple[List[str], np.ndarray,
                                       Optional[np.ndarray], IndexMap]:
    """-> (entity_ids, means [E, d], variances or None, index_map); models
    come back dense in ORIGINAL space (projection is a training-time
    artifact, reference loads are original-space too).  `path` may be a
    list of part files (reference partitioned layout)."""
    recs = _read_model_records(path)
    if index_map is None:
        index_map = build_index_map(model_record_keys(recs),
                                    add_intercept=True)
    return re_arrays_from_records(recs, index_map) + (index_map,)


def re_arrays_from_records(recs, index_map: IndexMap
                           ) -> Tuple[List[str], np.ndarray,
                                      Optional[np.ndarray]]:
    """Per-entity BayesianLinearModelAvro records -> (entity_ids,
    means [E, d], variances or None) dense in `index_map`'s order."""
    e_ids = [rec["modelId"] for rec in recs]
    d = index_map.size
    means = np.zeros((len(recs), d))
    any_var = any(rec.get("variances") for rec in recs)
    variances = np.zeros((len(recs), d)) if any_var else None
    for e, rec in enumerate(recs):
        for f in rec["means"]:
            j = index_map.index_of(f["name"], f["term"])
            if j >= 0:
                means[e, j] = f["value"]
        if any_var:
            for f in rec.get("variances") or ():
                j = index_map.index_of(f["name"], f["term"])
                if j >= 0:
                    variances[e, j] = f["value"]
    return e_ids, means, variances


# -- scores ------------------------------------------------------------------


def write_feature_stats_avro(path: str, summary, index_map: IndexMap) -> None:
    """Per-feature statistics -> FeatureSummarizationResultAvro records
    (reference: ModelProcessingUtils.writeBasicStatistics, scala:560-630 —
    one record per feature with the same metric-map keys)."""
    mean_abs = summary.mean_abs

    def gen():
        for j in range(index_map.size):
            name, term = index_map.name_term(j)
            yield {"featureName": name, "featureTerm": term,
                   "metrics": {"max": float(summary.max[j]),
                               "min": float(summary.min[j]),
                               "mean": float(summary.mean[j]),
                               "normL1": float(summary.norm_l1[j]),
                               "normL2": float(summary.norm_l2[j]),
                               "numNonzeros": float(summary.num_nonzeros[j]),
                               "variance": float(summary.variance[j]),
                               "meanAbs": float(mean_abs[j])}}

    write_container(path, FEATURE_SUMMARIZATION_RESULT_AVRO, gen())


def read_feature_stats_avro(path: str):
    """-> list of (name, term, metrics-dict), record order preserved."""
    return [(r["featureName"], r["featureTerm"], dict(r["metrics"]))
            for r in read_container(path)]


def write_scores_avro(path: str, model_id: str, scores: np.ndarray,
                      labels: Optional[np.ndarray] = None,
                      weights: Optional[np.ndarray] = None,
                      uids: Optional[List[Optional[str]]] = None) -> None:
    """reference: ScoreProcessingUtils.saveScoredItemsToHDFS."""
    def gen():
        for i, s in enumerate(np.asarray(scores)):
            yield {"uid": uids[i] if uids else None,
                   "label": None if labels is None else float(labels[i]),
                   "modelId": model_id, "predictionScore": float(s),
                   "weight": None if weights is None else float(weights[i]),
                   "metadataMap": None}
    write_container(path, SCORING_RESULT_AVRO, gen())


def read_scores_avro(path: str):
    recs = list(read_container(path))
    scores = np.asarray([r["predictionScore"] for r in recs])
    labels = np.asarray([r["label"] if r["label"] is not None else np.nan
                         for r in recs])
    return scores, labels, recs


# -- latent factors (matrix factorization) -----------------------------------


def write_latent_factors_avro(path: str, ids: Iterable[str],
                              factors: np.ndarray) -> None:
    write_container(path, LATENT_FACTOR_AVRO,
                    ({"effectId": str(i), "latentFactor": list(map(float, f))}
                     for i, f in zip(ids, np.asarray(factors))))


def read_latent_factors_avro(path: str) -> Tuple[List[str], np.ndarray]:
    recs = list(read_container(path))
    return ([r["effectId"] for r in recs],
            np.asarray([r["latentFactor"] for r in recs]))
