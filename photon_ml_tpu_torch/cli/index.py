"""Standalone feature-indexing job: prebuild frozen feature spaces (port of
photon_ml_tpu/cli/index.py, over the port's native Avro decoder).

Rebuild of the reference's FeatureIndexingJob (photon-client/.../
FeatureIndexingJob.scala:56-307): scan Avro training data's feature bags,
build one deterministic IndexMap per feature shard, and save them so
SEPARATE jobs (training on different data slices, offline scoring,
diagnostics) share a single frozen feature space.  npz map files replace
the reference's partitioned PalDB stores (documented descope); the train
CLI consumes the output via --index-map-dir.

  python -m photon_ml_tpu_torch.cli.index --data 'daily/*/part-*.avro' \
      --feature-shard-map '{"global": ["features"]}' --output maps/

Files are scanned ONE AT A TIME and only each file's feature-key
vocabulary crosses into Python, so peak memory is one decoded file plus
the union vocabulary — not the whole input range.
"""
from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-index")
    p.add_argument("--data", required=True,
                   help="Avro input: file, directory, or glob")
    p.add_argument("--feature-shard-map", default=None,
                   help="JSON (inline or @file) shard -> feature-bag merge "
                        "map (see cli.train); default merges the 'features' "
                        "bag into shard 'global'")
    p.add_argument("--output", required=True,
                   help="directory for the index-map collection")
    p.add_argument("--input-date-range", default=None,
                   help="yyyymmdd-yyyymmdd range over a daily/ tree")
    p.add_argument("--input-days-ago", default=None,
                   help="days-ago range, e.g. 90-1")
    return p


def scan_feature_shards(paths, feature_shard_map):
    """-> {shard: IndexMap}, one file decoded at a time; only each file's
    per-shard vocabulary is retained across files."""
    from photon_ml_tpu_torch.data import avro_native
    from photon_ml_tpu_torch.data.avro_codec import read_container
    from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key

    keys = {shard: set() for shard in feature_shard_map}
    for p in paths:
        cols = avro_native.read_columnar(p)
        avro_native.note_route(cols is not None)
        if cols is not None:
            for shard, bags in feature_shard_map.items():
                for bag in bags:
                    if f"{bag}#count" not in cols:
                        raise ValueError(
                            f"feature bag {bag!r} (shard {shard!r}) not "
                            f"found in the records of {p}")
                file_map, _ = avro_native.resolve_feature_keys(
                    [cols[f"{bag}.name"] for bag in bags],
                    [cols[f"{bag}.term"] for bag in bags], None)
                keys[shard].update(map(str, file_map.index_to_key))
            continue
        # pure-Python fallback (unsupported schema shapes)
        first = True
        for rec in read_container(p):
            if first:
                for shard, bags in feature_shard_map.items():
                    for bag in bags:
                        if bag not in rec:
                            raise ValueError(
                                f"feature bag {bag!r} (shard {shard!r}) "
                                f"not found in the records of {p}")
                first = False
            for shard, bags in feature_shard_map.items():
                for bag in bags:
                    for f in rec.get(bag) or ():
                        keys[shard].add(
                            feature_key(f["name"], f.get("term", "")))
    return {shard: IndexMap.from_keys(ks) for shard, ks in keys.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from photon_ml_tpu_torch.cli.train import (parse_feature_shard_map,
                                               resolve_avro_paths)
    from photon_ml_tpu_torch.data.index_map import IndexMapCollection

    if args.input_date_range or args.input_days_ago:
        import glob as _glob
        import os
        from photon_ml_tpu_torch.data.date_range import paths_for_date_range
        paths = []
        for d in paths_for_date_range(args.data, args.input_date_range,
                                      args.input_days_ago):
            paths.extend(sorted(_glob.glob(os.path.join(d, "*.avro"))))
        if not paths:
            raise SystemExit(f"no .avro files under {args.data!r} for the "
                             "requested date range")
    else:
        paths = resolve_avro_paths(args.data)
        if paths is None:
            raise SystemExit(
                f"--data {args.data!r} is not an Avro input; feature "
                "indexing scans Avro feature bags "
                "(reference: FeatureIndexingJob)")

    shard_map = parse_feature_shard_map(args.feature_shard_map)
    maps = scan_feature_shards(paths, shard_map)
    IndexMapCollection(maps).save(args.output)
    print(json.dumps({"output": args.output, "files_scanned": len(paths),
                      "shards": {s: m.size for s, m in maps.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
