"""The readings that the limits of ``correct`` are set from; the
benchmark's own runs never run this.

For each seed: the port's numbers over a short window of the cell at its
own size and load (a run as ``run.py`` makes it, without printing), then
the control's: the plain reference computed in the nearest precision below
the configuration's (the towers in fp8 e4m3, one scale a tensor, for the
bf16 towers), put in the port's place on the same sampled requests and
judged by the float32 reference.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control_seeds 1,2,3] --out readings.json

The lower reading of a number is the largest the port gives over a dozen
seeds or more; the upper is the smallest the control gives.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import run


def control_numbers(reg, name: str, seed: int, seconds: float, device,
                    precision: str = "fp8") -> dict:
    """The control's numbers on the requests a window of the port would
    sample: the reference in ``precision`` answers them in the port's
    place."""
    import torch

    from portbench import inputs

    plan = reg.plan(name)
    config, traffic, route = plan["config"], plan["traffic"], plan["route"]
    vocab = inputs.make_vocab(config["vocab"]["size"],
                              config["vocab"]["lead"], seed)
    gen = plan["generator"]
    requests = gen.stream(traffic, vocab, inputs.sub_seed(seed, "traffic"))
    n = max(traffic["check_requests"], 1)
    batches = [next(requests) for _ in range(n)]
    made = route.make_inputs(config, seed, device)
    low, _, _ = route.reference(config, traffic, seed, vocab, batches, made,
                                device, precision)
    served = [[(a["doc"], inputs.title(a["doc"]), a["start_pos"],
                a["end_pos"],
                inputs.doc_layout(config["index"])["context"][
                    a["start_pos"]:a["end_pos"]], a["score"]) for a in ans]
              for ans in low]
    sampled = [(b, served[i * len(b):(i + 1) * len(b)])
               for i, b in enumerate(batches)]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run.judge(route, config, traffic, seed, vocab, sampled, made,
                     device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", action="store_true",
                    help="also run each fault of faults.py on the seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_environment()
    import torch

    torch.set_num_threads(1)
    from portbench.registry import Registry

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    reg = Registry(run.CHECKOUT)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        line, info = run.run_cell(reg, args.workload, seed=seed,
                                    seconds=args.seconds, trace=False,
                                    device=device, t_process0=t0)
        rows.append({"side": "port", "seed": seed,
                     "numbers": {k: v["value"]
                                 for k, v in line["check"].items()},
                     "correct": line["correct"], **info,
                     "metrics": line["metrics"]})
        print(json.dumps(rows[-1]), flush=True)
    if args.faults:
        from portbench import faults

        for name, fault in sorted(faults.FAULTS.items()):
            for seed in [int(s) for s in args.control_seeds.split(",") if s]:
                line, _ = run.run_cell(
                    reg, args.workload, seed=seed, seconds=args.seconds,
                    trace=False, device=device,
                    t_process0=time.perf_counter(), fault=fault)
                rows.append({"side": name, "seed": seed,
                             "correct": line["correct"],
                             "numbers": {k: v["value"]
                                         for k, v in line["check"].items()}})
                print(json.dumps(rows[-1]), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        nums = control_numbers(reg, args.workload, seed, args.seconds,
                               device)
        rows.append({"side": "control", "seed": seed,
                     "numbers": {k: run.finite(v) for k, v in nums.items()}})
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for side in ("port", "control"):
        got = [r["numbers"] for r in rows if r["side"] == side]
        for key in ("score_gap", "rank_gap_mean", "rank_gap"):
            vals = [g[key] for g in got if key in g]
            if vals:
                summary[f"{side}_{key}"] = {"max": max(vals),
                                            "min": min(vals)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
