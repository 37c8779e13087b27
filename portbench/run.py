"""One run of one benchmark cell: set up, warm up, drive the cell's
traffic for ``--seconds``, check the answers against the plain reference,
print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The loop is closed: one client sends its next request when the answers to
the last are assembled, and each request's latency runs from its send to
its answers. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics: the requests of the window's first ``TRACE_S``
seconds run the untraced path under a device-only profile (the layer
calls only note their host intervals), the later ones with each layer
call ending in a sync and timed.

After the window the peak device memory is read, the port's state is
freed, and the reference answers a sample of the window's requests drawn
from the seed (``check.py``). The run fails, and prints no result, without
a card, or when a module of jax, jaxlib, flax or the JAX package is loaded.
Caches the port or its libraries build go to fixed directories under the
checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / "portbench" / ".cache"
TRACE_S = 4.0  # seconds of the window the traced run profiles
FORBIDDEN = ("jax", "jaxlib", "flax", "densephrases_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def set_environment() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds; one host thread for the CPU ops, so that a run
    is one process with few threads (on an H100 host, runs spread no wider
    or narrower for it, and their medians moved under 2%). Call before
    torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``densephrases_tpu_torch`` is not
    ``densephrases_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Sampler:
    """A uniform sample of ``k`` requests drawn from the seed (reservoir),
    plus the last request that held a query of the most words."""

    def __init__(self, k: int, seed: int, longest: int):
        import numpy as np

        self.k = k
        self.rng = np.random.default_rng(seed)
        self.longest = longest
        self.kept, self.last_longest = [], None

    def offer(self, i: int, texts, results) -> None:
        item = (i, texts, results)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = item
        if max(len(t.split()) for t in texts) >= self.longest:
            self.last_longest = item

    def sample(self) -> list:
        items = {i: (texts, res) for i, texts, res in self.kept}
        if self.last_longest is not None:
            i, texts, res = self.last_longest
            items[i] = (texts, res)
        return [items[i] for i in sorted(items)]


def closed_loop(served, requests, seconds: float, sampler, *,
                profile=None, trace_s: float = 0.0, spans=None):
    """Drive ``served`` for ``seconds``: the next request goes when the
    last is answered; the window ends when the last request sent before
    the deadline is answered. With ``profile`` (a ``trace.Profile``), the
    requests that start in the first ``trace_s`` seconds run under it, and
    ``spans`` then time the requests after them. → dict of the window's
    counts and latencies."""
    lat, queries, failed, traced, untraced = [], 0, 0, 0, 0
    errors, ends = [], []
    if profile is not None:
        profile.start()
        spans.intervals = []
        spans.profiling = served.tracing = True
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    t_end = t_start
    while time.perf_counter() < deadline:
        texts = next(requests)
        t0 = time.perf_counter()
        try:
            results = served.serve(texts)
        except Exception as exc:  # noqa: BLE001 -- a failed request counts
            failed += 1
            errors.append(repr(exc)[:300])
            results = None
        t_end = time.perf_counter()
        if results is not None:
            lat.append(t_end - t0)
            ends.append((t_end - t_start, len(texts)))
            queries += len(texts)
            sampler.offer(i, texts, results)
        i += 1
        if served.tracing:
            traced += 1
            if t_end - t_start >= trace_s:
                profile.stop()
                spans.profiling = served.tracing = False
                spans.seconds.clear()  # layer times of the later requests
                untraced = i
    if served.tracing:  # the window ended inside the profile
        profile.stop()
        spans.profiling = served.tracing = False
    return {"window_s": t_end - t_start, "requests": i, "failed": failed,
            "queries": queries, "latencies_s": lat, "errors": errors[:5],
            "ends": ends,
            "traced_requests": traced, "span_requests": i - untraced}


def run_cell(reg, name: str, *, seed: int, seconds: float, trace: bool,
             device, t_process0: float, fault=None) -> tuple:
    """One run; → (result line dict, {"errors": the first failed requests'
    errors, "check_s": the comparison's seconds}). ``fault`` (tests): called
    with the served object before the warm-up, to break the timed path
    underneath."""
    import torch

    from portbench import check, inputs, port
    from portbench import trace as tr

    plan = reg.plan(name)
    config, traffic, route = plan["config"], plan["traffic"], plan["route"]
    vocab = inputs.make_vocab(config["vocab"]["size"],
                              config["vocab"]["lead"], seed)
    made = route.make_inputs(config, seed, device)
    if device.type == "cuda":  # the peak of the port's set-up and window
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    served = route.Served(config, traffic, seed, vocab, device, made)
    if fault is not None:
        fault(served)
    gen = plan["generator"]
    warm = gen.stream(traffic, vocab, inputs.sub_seed(seed, "warm"))
    for _ in range(traffic["warm_requests"]):
        served.serve(next(warm))
    spans = None
    if trace:
        spans = tr.Spans(device)
        spans.install(served.layers())
        served.serve(next(warm))  # the wrapped calls, once before the clock
        spans.seconds.clear()
    tr.sync(device)
    sampler = Sampler(traffic["check_requests"],
                      inputs.sub_seed(seed, "sample"), traffic["words"][1])
    requests = gen.stream(traffic, vocab, inputs.sub_seed(seed, "traffic"))
    profile = tr.Profile(device) if trace else None
    served.tracing = False
    t_window = time.perf_counter()
    win = closed_loop(served, requests, seconds, sampler, profile=profile,
                      trace_s=TRACE_S, spans=spans)
    mem_peak = (int(torch.cuda.max_memory_allocated(device))
                if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise SystemExit("loaded in the run's process: " + ", ".join(bad))
    sampled = [(texts, [port.served_answers(r) for r in res])
               for texts, res in sampler.sample()]
    ctx = dict(win, setup_s=t_window - t_process0, mem_peak_bytes=mem_peak,
               work=route.request_work(config, traffic), trace=None)
    if trace:
        ctx["spans"] = dict(spans.seconds)
        ctx["pq_launches"] = getattr(served, "traced_work", lambda: None)()
        ctx["trace"] = tr.read_trace(tr.export(profile.prof), profile.marks,
                                     spans.intervals)
    served.close()
    del served, sampler, profile
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge(route, config, traffic, seed, vocab, sampled, made,
                    device)
    check_s = time.perf_counter() - t_check
    limits = reg.cell(name)["limits"]
    correct = (win["failed"] == 0 and bool(sampled)
               and check.verdict(numbers, limits))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mname, reader in plan[kind].items():
        value = reader.read(ctx)
        if value is not None:
            metrics[mname] = {"value": value, "unit": reader.UNIT}
    line = {"correct": correct, "attempted": win["requests"],
            "failed": win["failed"], "metrics": metrics,
            "device": device_info(device, mem_peak)}
    if trace and ctx["trace"]:
        line["device"]["busy_s"] = ctx["trace"]["busy_s"]
        line["device"]["window_s"] = ctx["trace"]["window_s"]
        line["breakdown"] = breakdown(ctx["trace"])
    compared = {k: {"value": finite(numbers[k]), "limit": limits.get(k)}
                for k in numbers}
    compared["failed"] = {"value": win["failed"], "limit": 0}
    line["check"] = compared
    return line, {"errors": win["errors"], "check_s": check_s,
                  "slices": slice_rates(win["ends"], win["window_s"])}


def slice_rates(ends, window_s: float, slice_s: float = 10.0) -> list:
    """Queries answered a second in each whole ``slice_s`` of the window
    (``ends``: each answered request's end, seconds into the window, and
    its queries): whether runs differ inside a process or between
    processes."""
    n = int(window_s // slice_s)
    counts = [0] * n
    for t, q in ends:
        if int(t // slice_s) < n:
            counts[int(t // slice_s)] += q
    return [c / slice_s for c in counts]


def judge(route, config, traffic, seed, vocab, sampled, made, device,
          precision: str = "fp32") -> dict:
    """The sampled requests' served answers against the reference's."""
    from portbench import check, inputs
    from portbench.reference import no_tf32

    no_tf32()
    batches = [texts for texts, _ in sampled]
    ref, units, scorer = route.reference(config, traffic, seed, vocab,
                                         batches, made, device, precision)
    served = [a for _, answers in sampled for a in answers]
    return check.judge(served, ref, units, scorer,
                       layout=inputs.doc_layout(config["index"]),
                       n_docs=config["index"]["n_docs"],
                       top_k=traffic["top_k"],
                       max_len=traffic["max_answer_length"])


def finite(x: float) -> float:
    """JSON has no infinity: a number that is not finite prints as 1e300."""
    return x if math.isfinite(x) else 1e300


def device_info(device, mem_peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": mem_peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": mem_peak}
    try:
        import subprocess

        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return info


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_process0 = time.perf_counter() - process_age_s()
    args = parse_args(argv)
    set_environment()
    import torch

    torch.set_num_threads(1)
    from portbench.registry import Registry

    reg = Registry(CHECKOUT)
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line, info = run_cell(reg, args.workload, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=device, t_process0=t_process0)
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded in the run's process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for err in info["errors"]:
        print(f"portbench: a request failed: {err}", file=sys.stderr)
    print(f"portbench: the check took {info['check_s']:.1f} s",
          file=sys.stderr)
    print("portbench: q/s by 10 s of the window: "
          + ", ".join(f"{r:.1f}" for r in info["slices"]), file=sys.stderr)
    for key, v in line["check"].items():
        print(f"check {key} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
