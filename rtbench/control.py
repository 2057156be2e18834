"""Readings for the limits of ``correct``: the program's numbers over many
seeds (the lower readings), and the control's (the upper ones).

    python3 rtbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program-seconds 3] [--control] [--out chiprun_out/x.jsonl]

``--program-seconds``: run the cell (``harness.run``, its timed path at its
own sizes) for each seed with a window of that length, and record its
numbers. ``--control``: for each seed, the plain reference computed in
bfloat16 (the precision below the configuration's float32) put in the
program's place, on the same sampled rays, judged by the same numbers
against the float64 reference. One process reads every seed, so set-up is
paid once for the CUDA context and the libraries. The benchmark's runs do
not run this.
"""
import argparse
import io
import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from rtbench import harness, traffic  # noqa: E402


def control_numbers(workload: str, seed: int, device: str = "cuda",
                    rehearsal: bool = False, dtype=torch.bfloat16) -> dict:
    """The control's numbers on the cell's sample for ``seed``."""
    spec = harness.cell(workload, rehearsal)
    mix, lim, ans = spec["mix"], spec["limits"], spec["answer"]
    ref_mod = spec["reference"]
    import embree_tpu_torch as pt
    arrays = spec["scene"].generate(spec["sizes"], seed)
    pool = traffic.make_pool(mix, seed, device, pt)
    idx = traffic.sample(traffic.n_rays(mix), lim["sample_per_batch"],
                         len(pool), seed, device)
    ref = harness.reference_answers(ans, ref_mod, arrays, pool, idx, device,
                                    torch.float64)
    low = harness.reference_answers(ans, ref_mod, arrays, pool, idx, device,
                                    dtype)
    taken = [(b, ans.as_answers(x)) for b, x in enumerate(low)]
    numbers, failed = harness.judge_calls(ans, taken, ref, lim["limits"])
    return {"numbers": numbers, "failed_batches": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    rows = []
    for seed in seeds:
        if a.program_seconds > 0:
            buf, errs = io.StringIO(), io.StringIO()
            t = time.perf_counter()
            rc = harness.run(a.workload, seed, a.program_seconds, False,
                             t, out=buf, err=errs)
            line = json.loads(buf.getvalue().splitlines()[-1])
            rows.append({"seed": seed, "side": "program", "rc": rc,
                         "correct": line["correct"],
                         "calls": line["attempted"],
                         "numbers": {k: v["value"]
                                     for k, v in line["checks"].items()}})
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
        if a.control:
            t = time.perf_counter()
            r = control_numbers(a.workload, seed)
            rows.append({"seed": seed, "side": "control",
                         "seconds": time.perf_counter() - t, **r})
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            for r in rows:
                f.write(json.dumps(dict(r, workload=a.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
