"""Named-feature box-constraint maps
(a copy of photon_ml_tpu/optim/constraints.py; host code).

Rebuild of the reference's constraint-string machinery (photon-client/.../
io/deprecated/GLMSuite.scala:206-280 `createConstraintFeatureMap` +
ConstraintMapKeys.scala): a JSON list of

    {"name": ..., "term": ..., "lowerBound": ..., "upperBound": ...}

entries resolves through a feature shard's IndexMap into the positional
per-coefficient (lower, upper) arrays the optimizer takes — nobody writes a
14,983-element bounds array by hand.  Semantics match the reference:

  - a missing lowerBound/upperBound defaults to -inf/+inf; at least one
    bound must be finite and lower < upper
  - name "*" + term "*" applies to every feature EXCEPT the intercept and
    must be the only entry
  - name "*" with a specific term is unsupported (so here too)
  - a specific name + term "*" applies to every term of that name;
    conflicting bounds for one feature are an error
  - a (name, term) absent from the index map is silently skipped (the
    reference's `featureKeyToIdMap.get(...).foreach`)
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from photon_ml_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap

WILDCARD = "*"  # reference: Constants.WILDCARD

# canonical in-config form: (name, term, lower, upper)
ConstraintEntry = Tuple[str, str, float, float]


def normalize_constraints(raw: Sequence) -> Tuple[ConstraintEntry, ...]:
    """Validate + canonicalize user-supplied entries (dicts in the
    reference's JSON shape, or already-canonical 4-tuples)."""
    out: List[ConstraintEntry] = []
    for entry in raw:
        if isinstance(entry, dict):
            unknown = set(entry) - {"name", "term", "lowerBound", "upperBound"}
            if unknown:
                raise ValueError(
                    f"unknown constraint keys {sorted(unknown)} in {entry!r} "
                    "(expected name/term/lowerBound/upperBound)")
            if "name" not in entry or "term" not in entry:
                raise ValueError(
                    f"constraint entry must specify 'name' and 'term' "
                    f"(reference: ConstraintMapKeys), got {entry!r}")
            name, term = str(entry["name"]), str(entry["term"])
            lower = float(entry.get("lowerBound", -math.inf))
            upper = float(entry.get("upperBound", math.inf))
        else:
            name, term, lower, upper = entry
            name, term = str(name), str(term)
            lower, upper = float(lower), float(upper)
        if lower == -math.inf and upper == math.inf:
            raise ValueError(
                f"constraint for name [{name}] term [{term}] has bounds "
                "(-inf, +inf); an unconstrained entry is invalid "
                "(reference: GLMSuite.scala:224-226)")
        if not lower < upper:
            raise ValueError(
                f"lower bound [{lower}] must be < upper bound [{upper}] "
                f"for name [{name}] term [{term}]")
        if name == WILDCARD and term != WILDCARD:
            raise ValueError(
                "wildcard in feature name alone is unsupported: a '*' name "
                "requires a '*' term (reference: GLMSuite.scala:245-248)")
        out.append((name, term, lower, upper))
    if any(n == WILDCARD and t == WILDCARD for n, t, _, _ in out) \
            and len(out) > 1:
        raise ValueError(
            "a name='*' term='*' constraint must be the only entry "
            "(reference: GLMSuite.scala:236-243)")
    return tuple(out)


def resolve_constraints(
    constraints: Sequence[ConstraintEntry],
    index_map: IndexMap,
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """-> positional (box_lower, box_upper) tuples of length
    index_map.size, with ±inf for unconstrained coefficients."""
    bounds: Dict[int, Tuple[float, float]] = {}

    def put(j: int, lo: float, hi: float, label: str) -> None:
        if j in bounds:
            raise ValueError(
                f"conflicting bounds for feature {label}: already "
                f"{bounds[j]}, attempted {(lo, hi)} "
                "(reference: GLMSuite.scala:253-259)")
        bounds[j] = (lo, hi)

    for name, term, lo, hi in constraints:
        if name == WILDCARD and term == WILDCARD:
            for key, j in index_map.key_to_index.items():
                if key != INTERCEPT_KEY:
                    bounds[j] = (lo, hi)
        elif term == WILDCARD:
            prefix = name + DELIMITER
            for key, j in index_map.key_to_index.items():
                if key.startswith(prefix):
                    put(j, lo, hi, f"[{key.replace(DELIMITER, '.')}]")
        else:
            j = index_map.index_of(name, term)
            if j >= 0:  # unseen features are skipped, as in the reference
                put(j, lo, hi, f"name [{name}] term [{term}]")

    lower = [-math.inf] * index_map.size
    upper = [math.inf] * index_map.size
    for j, (lo, hi) in bounds.items():
        lower[j], upper[j] = lo, hi
    return tuple(lower), tuple(upper)


def constraints_to_json(constraints: Sequence[ConstraintEntry]) -> List[dict]:
    """Canonical tuples -> the reference's JSON shape (omitting infinite
    bounds, which are representationally absent there too)."""
    out = []
    for name, term, lo, hi in constraints:
        d = {"name": name, "term": term}
        if lo != -math.inf:
            d["lowerBound"] = lo
        if hi != math.inf:
            d["upperBound"] = hi
        out.append(d)
    return out
