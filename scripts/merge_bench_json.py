"""Merge two bench.py result JSONs: the fresh run wins every key it has;
sections the fresh run SKIPPED (time budget) or errored are carried from the
earlier run with a `carried_from` provenance marker.

Use: a full bench that spends its budget on the 10M rows may skip the
breadth/streaming rows that an earlier run on the same code and card already
measured; the merged JSON must not silently LOSE those rows.

Usage: python scripts/merge_bench_json.py fresh.json earlier.json out.json
"""

import json
import sys


def main():
    fresh_p, earlier_p, out_p = sys.argv[1], sys.argv[2], sys.argv[3]
    with open(fresh_p) as f:
        fresh = json.loads(f.read().strip().splitlines()[-1])
    with open(earlier_p) as f:
        earlier = json.loads(f.read().strip().splitlines()[-1])

    carried = []
    for key, val in earlier.items():
        fval = fresh.get(key)
        missing = key not in fresh
        errored = isinstance(fval, dict) and set(fval) == {"error"}
        if (missing or errored) and not (
            isinstance(val, dict) and set(val) == {"error"}
        ):
            fresh[key] = val
            if isinstance(fresh[key], dict):
                fresh[key] = dict(fresh[key], carried_from=earlier_p)
            carried.append(key)
    if carried:
        fresh["carried_sections"] = {
            "from": earlier_p,
            "keys": carried,
            "note": "sections the fresh run skipped (time budget) or "
                    "errored, measured earlier the same day on the same "
                    "code + chip",
        }
    with open(out_p, "w") as f:
        f.write(json.dumps(fresh) + "\n")
    print(f"merged: carried {carried or 'nothing'} -> {out_p}")


if __name__ == "__main__":
    main()
