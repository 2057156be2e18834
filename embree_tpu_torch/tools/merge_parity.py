"""Merge per-tier MODELS_PARITY partial runs into the round artifact.

Port of embree_tpu/tools/merge_parity.py (plain Python, the same JSON).
Every entry is stamped with the backend that produced it and the round:
a stale merged artifact once hid a regression for a round, so every scene
carries its provenance.

Usage: python -m embree_tpu_torch.tools.merge_parity OUT round [tag=FILE ...]
Later files win on key collisions (list the accelerator's runs last).
"""
import json
import sys


def main(argv):
    out_path, round_tag = argv[0], argv[1]
    merged = {}
    meta = {"pass": 0, "fail": 0, "skip": 0}
    for spec in argv[2:]:
        tag, path = spec.split("=", 1)
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            print(f"missing {path}, skipped")
            continue
        for name, val in data.get("results", {}).items():
            merged[name] = {"result": val, "backend": tag,
                            "round": round_tag}
    thresh = 55.0
    for name, row in merged.items():
        v = row["result"]
        if isinstance(v, str):
            if v.startswith("SKIP"):
                meta["skip"] += 1
            elif v.startswith("SMOKE ok"):
                meta["pass"] += 1
            else:
                meta["fail"] += 1
        else:
            meta["pass" if v <= thresh else "fail"] += 1
    outj = {"round": round_tag, "threshold": thresh, **meta,
            "n_scenes": len(merged),
            "results": {k: merged[k] for k in sorted(merged)}}
    with open(out_path, "w") as f:
        json.dump(outj, f, indent=1)
    print(f"{meta['pass']} pass / {meta['fail']} fail / {meta['skip']} skip "
          f"over {len(merged)} scenes -> {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
