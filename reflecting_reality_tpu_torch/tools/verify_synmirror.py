"""SynMirror ingest verification: schema manifest + checksums + corruption scan
(the port's copy of `reflecting_reality_tpu/tools/verify_synmirror.py`).

It checks that a real shard's keys, dtypes and shapes match what the
loader expects (reference schema: examples/brushnet/dataset/dataset.py:205-223 —
`colors` uint8 HxWx3, `category_id_segmaps` int HxW with 1=mirror 2=object,
`depth` float HxW, `normals` float HxWx3 in [0,1], `cam_states` JSON bytes).

Three jobs, one pass over the files:

1. **Schema validation** — per file: required keys present, dtype kinds and
   ranks as the loader assumes, spatial dims consistent across planes,
   decodable cam_states (`data.synmirror.decode_cam_states` needs
   cam2world and cam_K). Violations are loader-crash-grade and reported
   per-uid.
2. **Content corruption scan** — reuses tools/test_dataset.check_sample
   (null/black/constant/mask-missing checks, the reference's
   scripts/test_dataset.py semantics).
3. **Manifest** — writes manifest.json: per-file {sha256?, keys, dtypes,
   shapes} plus corpus aggregates (shape histogram, dtype sets, index
   coverage).  A later run with --expect manifest.json verifies a copied /
   re-downloaded corpus byte-for-byte (with --checksums) or
   structure-for-structure against the recorded state.

The CSV index is cross-checked both ways: rows whose `path` is missing on
disk, and .hdf5 files not referenced by any row.

Usage:
    python -m reflecting_reality_tpu_torch.tools.verify_synmirror \
        --data_dir /data/synmirror --csv train.csv \
        --manifest manifest.json [--checksums] [--workers 16]
    # later, against a fresh copy:
    python -m reflecting_reality_tpu_torch.tools.verify_synmirror \
        --data_dir /data/synmirror2 --csv train.csv --expect manifest.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

# the loader's structural assumptions (synmirror.extract_data_from_hdf5)
REQUIRED_KEYS = ("colors", "category_id_segmaps", "depth", "normals")
OPTIONAL_KEYS = ("cam_states",)
# dtype KIND + rank per key: colors uint HxWx3; segmap int/uint HxW;
# depth float HxW (or HxWx1); normals float HxWx3
SCHEMA = {
    "colors": (("u", "i"), (3,)),
    "category_id_segmaps": (("u", "i"), (2,)),
    "depth": (("f",), (2, 3)),
    "normals": (("f",), (3,)),
}


def file_sha256(path: str, bufsize: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(bufsize)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def inspect_file(path: str, checksum: bool = False,
                 content_scan: bool = True) -> Dict:
    """Schema + (optional) content report for one .hdf5 sample."""
    rec: Dict = {"keys": {}, "errors": []}
    try:
        with h5py.File(path, "r") as f:
            present = set(f.keys())
            for key in REQUIRED_KEYS:
                if key not in present:
                    rec["errors"].append(f"missing key {key}")
            for key in sorted(present):
                ds = f[key]
                shape = tuple(ds.shape) if ds.shape is not None else None
                rec["keys"][key] = {
                    "dtype": str(ds.dtype),
                    "shape": list(shape) if shape else None,
                }
            spatial = set()
            for key, (kinds, ranks) in SCHEMA.items():
                if key not in present:
                    continue
                ds = f[key]
                if ds.shape is None:
                    rec["errors"].append(f"{key}: null dataset")
                    continue
                if ds.dtype.kind not in kinds:
                    rec["errors"].append(
                        f"{key}: dtype {ds.dtype} (kind {ds.dtype.kind!r}) "
                        f"not in expected kinds {kinds}")
                if len(ds.shape) not in ranks:
                    rec["errors"].append(
                        f"{key}: rank {len(ds.shape)} not in {ranks}")
                elif key == "colors" and ds.shape[-1] != 3:
                    rec["errors"].append(f"colors: last dim {ds.shape[-1]} != 3")
                elif key == "normals" and ds.shape[-1] != 3:
                    rec["errors"].append(f"normals: last dim {ds.shape[-1]} != 3")
                if len(ds.shape) >= 2:
                    spatial.add(tuple(ds.shape[:2]))
            if len(spatial) > 1:
                rec["errors"].append(f"inconsistent spatial dims: {sorted(spatial)}")
            if "cam_states" in present:
                try:
                    raw = np.asarray(f["cam_states"]).tobytes()
                    decoded = json.loads(raw.decode("utf-8"))
                    if not {"cam2world", "cam_K"} <= set(decoded):
                        rec["errors"].append(
                            "cam_states: missing cam2world/cam_K")
                except Exception as e:  # undecodable JSON blob
                    rec["errors"].append(f"cam_states: undecodable ({e})")
    except OSError as e:
        rec["errors"].append(f"unreadable hdf5: {e}")
        return rec

    if content_scan and not rec["errors"]:
        from reflecting_reality_tpu_torch.tools.test_dataset import check_sample

        try:
            reason = check_sample(path)
        except Exception as e:  # content checks assume schema held
            reason = f"content scan failed: {e}"
        if reason:
            rec["errors"].append(f"content: {reason}")
    if checksum:
        rec["sha256"] = file_sha256(path)
    return rec


def collect_files(data_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(data_dir):
        for name in files:
            if name.endswith(".hdf5") or name.endswith(".h5"):
                out.append(os.path.relpath(os.path.join(root, name), data_dir))
    return sorted(out)


def index_coverage(data_dir: str, csv_name: str,
                   files: List[str]) -> Tuple[List[str], List[str]]:
    """(index rows whose path is missing on disk, files no row references)."""
    import pandas as pd

    df = pd.read_csv(os.path.join(data_dir, csv_name))
    if "path" not in df.columns:
        return [f"index {csv_name} has no 'path' column"], []
    have = set(files)
    missing = [p for p in df["path"].astype(str)
               if p not in have and not os.path.isfile(os.path.join(data_dir, p))]
    referenced = set(df["path"].astype(str))
    orphans = [f for f in files if f not in referenced]
    return missing, orphans


def build_manifest(data_dir: str, csv_name: Optional[str], checksums: bool,
                   workers: int, content_scan: bool = True,
                   limit: Optional[int] = None) -> Dict:
    files = collect_files(data_dir)
    if limit:
        files = files[:limit]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        recs = list(pool.map(
            lambda rel: inspect_file(os.path.join(data_dir, rel),
                                     checksum=checksums,
                                     content_scan=content_scan),
            files))
    per_file = dict(zip(files, recs))

    shape_hist: Dict[str, int] = {}
    dtypes: Dict[str, set] = {}
    for rec in recs:
        for key, meta in rec["keys"].items():
            s = f"{key}:{tuple(meta['shape'] or ())}"
            shape_hist[s] = shape_hist.get(s, 0) + 1
            dtypes.setdefault(key, set()).add(meta["dtype"])

    manifest = {
        "schema_version": 1,
        "data_dir": os.path.abspath(data_dir),
        "n_files": len(files),
        "files": per_file,
        "aggregate": {
            "shape_histogram": dict(sorted(shape_hist.items())),
            "dtypes": {k: sorted(v) for k, v in sorted(dtypes.items())},
        },
        "corrupt": sorted(f for f, r in per_file.items() if r["errors"]),
    }
    if csv_name:
        missing, orphans = index_coverage(data_dir, csv_name, files)
        manifest["index"] = {"csv": csv_name, "missing_rows": missing,
                             "orphan_files": orphans}
    return manifest


def compare_manifests(expected: Dict, actual: Dict) -> List[str]:
    """Structural (and, when both carry sha256, byte-level) diff."""
    diffs = []
    exp_files, act_files = set(expected["files"]), set(actual["files"])
    for f in sorted(exp_files - act_files):
        diffs.append(f"missing file: {f}")
    for f in sorted(act_files - exp_files):
        diffs.append(f"unexpected file: {f}")
    for f in sorted(exp_files & act_files):
        e, a = expected["files"][f], actual["files"][f]
        if e.get("sha256") and a.get("sha256") and e["sha256"] != a["sha256"]:
            diffs.append(f"{f}: sha256 mismatch")
            continue
        if e["keys"] != a["keys"]:
            diffs.append(f"{f}: schema changed {e['keys']} -> {a['keys']}")
        if bool(e["errors"]) != bool(a["errors"]):
            diffs.append(f"{f}: corruption state changed "
                         f"({e['errors']} -> {a['errors']})")
    return diffs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--csv", default=None,
                   help="index csv (relative to data_dir) to cross-check")
    p.add_argument("--manifest", default=None,
                   help="write manifest JSON here")
    p.add_argument("--expect", default=None,
                   help="verify against a previously written manifest")
    p.add_argument("--checksums", action="store_true",
                   help="sha256 every file (slow on the full corpus; do it "
                        "once per canonical copy)")
    p.add_argument("--no_content_scan", action="store_true",
                   help="schema/shape only (content scan reads every plane)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--limit", type=int, default=None,
                   help="first N files only (smoke run)")
    args = p.parse_args(argv)

    if h5py is None:
        print("h5py unavailable", file=sys.stderr)
        return 2

    manifest = build_manifest(args.data_dir, args.csv, args.checksums,
                              args.workers,
                              content_scan=not args.no_content_scan,
                              limit=args.limit)

    n_bad = len(manifest["corrupt"])
    print(f"{manifest['n_files']} files; {n_bad} corrupt/invalid")
    for f in manifest["corrupt"][:20]:
        print(f"  BAD {f}: {'; '.join(manifest['files'][f]['errors'])}")
    if n_bad > 20:
        print(f"  ... and {n_bad - 20} more (see manifest)")
    if args.csv and manifest.get("index"):
        idx = manifest["index"]
        print(f"index: {len(idx['missing_rows'])} rows missing on disk, "
              f"{len(idx['orphan_files'])} orphan files")
        for r in idx["missing_rows"][:10]:
            print(f"  MISSING {r}")
    print("shape histogram:", json.dumps(
        manifest["aggregate"]["shape_histogram"], indent=2)[:2000])

    rc = 0
    if args.expect:
        with open(args.expect) as f:
            expected = json.load(f)
        diffs = compare_manifests(expected, manifest)
        if diffs:
            print(f"MANIFEST MISMATCH ({len(diffs)} diffs):")
            for d in diffs[:50]:
                print(f"  {d}")
            rc = 1
        else:
            print("manifest matches expected")

    if n_bad or (args.csv and manifest.get("index", {}).get("missing_rows")):
        rc = max(rc, 1)

    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        print(f"wrote {args.manifest}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
