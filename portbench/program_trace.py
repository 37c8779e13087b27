"""The port's own spans and counters (``densephrases_tpu_torch/utils/
profiling.py``) joined to a device profile, and a study run of one cell
that reads them:

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        [--rounds 3] [--profile_s 4] [--plain_s 8]

``join`` puts each device operation down to the innermost program span
open when its launch call ran (the operation's correlation id names the
``cuda_runtime`` call, whose host time lies on the spans' clock once the
marker kernels of ``trace.Profile`` tie the clocks), counts the launch
calls inside each request, and names each idle gap by the innermost span
open where it begins: a program span where one is open, else the
harness's wrapped call (``portbench.<layer>``), else
``portbench.client``. The readers below turn a study's readings into the
per-layer numbers the spans and counters give; each returns None where
its input is missing (the flat route counts no IVF rows; a CPU profile
has no device events; a port without the tracer records nothing).

The study (``study``) warms the cell up, then, under one device profile,
serves ``profile_s`` seconds of the closed loop with program tracing off
and on, in turns, ``rounds`` times each (the q/s of each part, and the
join of each traced one), then ``plain_s`` seconds unprofiled off and on
as often (q/s, and the host self times of the traced parts). It checks no
answers and is not one of the benchmark's runs: ``run.py`` turns no
program tracing on.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import statistics
import sys
import time
from collections import defaultdict

from portbench import trace as tr

# the spans whose host self time is the launch work the host does for the
# device (``dispatch_ms``)
DISPATCH = ("towers.forward", "index.flat.scan", "index.ivf.",
            "index.rescore", "serve.copy")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def tracer():
    """The port's tracer module, or None where the port has none."""
    try:
        from densephrases_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


class Innermost:
    """The innermost of nested intervals ``(start, end, payload)`` open at
    a time: the latest-starting one that covers it. The lookup walks back
    from the last start at or before the time for as long as an earlier
    interval still reaches it, so it finds the root of a request of any
    depth past any number of closed siblings."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.reach = list(itertools.accumulate((x[1] for x in self.items),
                                               max))

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            a, b, payload = self.items[i]
            if b >= t:
                return payload
            i -= 1
        return None


def _chains(spans) -> dict:
    """span id → (name, request, names of it and its ancestors)."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        names, p = [s.name], s.parent
        while p is not None and p in by_id:
            names.append(by_id[p].name)
            p = by_id[p].parent
        out[s.id] = (s.name, s.request, tuple(names))
    return out


def join(trace: dict, marks, spans, intervals=(), window=None) -> dict:
    """→ {"window_s", "busy_s", "requests" (the ids of the requests whose
    root spans lie in the window), "launches" ({request id: launch calls
    whose device work ran in the window}), "self" ({innermost span name:
    [device s, operations]}), "under" ({span name: [device s, operations]
    of the operations launched inside it, nested ones included}), "idle"
    ({name: seconds}, each gap by where it begins), "idle_during" (each
    gap split by the innermost span open at each instant of it)} over
    ``window`` (host times; default: from the
    first to the last of ``marks``, the host times of the profile's marker
    launches, in order). ``spans``: the program's spans; ``intervals``:
    the harness's wrapped calls (start, end, layer)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    marker = sorted(launch[e["args"]["correlation"]] for e in events
                    if e.get("cat") == "kernel" and tr.MARKER in e["name"]
                    and e.get("args", {}).get("correlation") in launch)
    h0, h1 = window or (marks[0], marks[-1])
    roots = {s.request for s in spans if s.name == "serve.request"
             and s.start >= h0 and s.end <= h1}
    out = {"window_s": h1 - h0, "busy_s": 0.0, "requests": sorted(roots),
           "launches": {}, "self": {}, "under": {}, "idle": {},
           "idle_during": {}}
    if not marker:
        return out
    offset = marks[0] - marker[0] * 1e-6  # trace µs → host seconds
    w0, w1 = (h0 - offset) * 1e6, (h1 - offset) * 1e6
    chains = _chains(spans)
    program = Innermost((s.start, s.end, s.id) for s in spans)
    harness = Innermost((a, b, f"portbench.{layer}")
                        for a, b, layer in intervals)
    busy, launches = [], defaultdict(int)
    own = defaultdict(lambda: [0.0, 0])
    under = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") not in tr.DEVICE_CATS or tr.MARKER in e["name"]:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        busy.append((a, b))
        corr = e.get("args", {}).get("correlation")
        sid = (program.at(launch[corr] * 1e-6 + offset)
               if corr in launch else None)
        name, rid, names = chains.get(sid, ("none", None, ("none",)))
        own[name][0] += (b - a) * 1e-6
        own[name][1] += 1
        for n in set(names):
            under[n][0] += (b - a) * 1e-6
            under[n][1] += 1
        if rid is not None:
            launches[rid] += 1
    def name_at(host):
        sid = program.at(host)
        if sid is not None:
            return chains[sid][0]
        return harness.at(host) or "portbench.client"

    # every span's ends, to split a gap where the host moved on
    cuts = sorted({t for s in spans for t in (s.start, s.end)}
                  | {t for a, b, _ in intervals for t in (a, b)})
    merged = tr._merge(busy)
    idle, during = defaultdict(float), defaultdict(float)
    edge = w0
    for a, b in merged + [[w1, w1]]:
        if a > edge:
            g0, g1 = edge * 1e-6 + offset, a * 1e-6 + offset
            idle[name_at(g0)] += g1 - g0
            inner = cuts[bisect.bisect_right(cuts, g0):
                         bisect.bisect_left(cuts, g1)]
            for x, y in zip([g0] + inner, inner + [g1]):
                during[name_at((x + y) / 2)] += y - x
        edge = max(edge, b)
    out.update(busy_s=sum(b - a for a, b in merged) * 1e-6,
               launches=dict(launches), self=dict(own), under=dict(under),
               idle=dict(idle), idle_during=dict(during))
    return out


def self_times(spans) -> dict:
    """Host self time by span name: each span's length less its
    children's."""
    inner = defaultdict(float)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.end - s.start
    out = defaultdict(float)
    for s in spans:
        out[s.name] += s.end - s.start - inner[s.id]
    return dict(out)


# ------------------------------------------------------------- readers
# Each takes a study's ``readings``: {"joined": a ``join`` of a profiled
# part, "plain_self": ``self_times`` summed over the unprofiled traced
# requests, "plain_requests": their count, "counters": the counters of
# every traced request}.
def _per_request(readings, value):
    joined = readings.get("joined")
    if not joined or not joined["requests"] or joined["busy_s"] <= 0:
        return None
    return value(joined) / len(joined["requests"])


def launches(readings):
    """Launch calls with device work a profiled request."""
    return _per_request(readings, lambda j: sum(
        n for rid, n in j["launches"].items() if rid in set(j["requests"])))


def towers_device_ms(readings):
    """Device ms a profiled request of the operations launched in the
    towers' spans."""
    return _per_request(readings, lambda j: 1e3 * sum(
        v[0] for k, v in j["under"].items() if k.startswith("towers.")))


def search_device_ms(readings):
    """Device ms a profiled request of the operations launched in stage 1
    and the rescore."""
    return _per_request(readings, lambda j: 1e3 * sum(
        j["under"].get(k, [0.0])[0]
        for k in ("index.search_dense", "index.rescore")))


def dispatch_ms(readings):
    """Host self ms a request of the spans that launch the device work,
    over unprofiled traced requests (``plain_self``: ``self_times`` summed
    over them)."""
    own, n = readings.get("plain_self"), readings.get("plain_requests")
    if not own or not n:
        return None
    return 1e3 * sum(v for k, v in own.items() if k.startswith(DISPATCH)) / n


def _share(readings, part: str, whole: str):
    c = readings.get("counters") or {}
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]


def ivf_scan_useful(readings):
    """% of the IVF scan's rows that lay in the probing row's own lists."""
    return _share(readings, "index.ivf.rows_own", "index.ivf.rows_scored")


def towers_token_useful(readings):
    """% of the towers' padded tokens that are real."""
    return _share(readings, "towers.tokens_real", "towers.tokens_padded")


DEVICE_READERS = ("launches", "towers_device_ms", "search_device_ms")
READERS = {"launches": launches, "towers_device_ms": towers_device_ms,
           "search_device_ms": search_device_ms, "dispatch_ms": dispatch_ms,
           "ivf_scan_useful": ivf_scan_useful,
           "towers_token_useful": towers_token_useful}


# --------------------------------------------------------------- study
def _serve_for(served, requests, seconds: float) -> tuple:
    """Closed loop for ``seconds``; → (queries, requests, seconds)."""
    t0 = time.perf_counter()
    queries = n = 0
    while time.perf_counter() - t0 < seconds:
        texts = next(requests)
        served.serve(texts)
        queries += len(texts)
        n += 1
    return queries, n, time.perf_counter() - t0


def _top(d: dict, k: int = 12) -> list:
    key = (lambda kv: -kv[1][0]) if d and isinstance(
        next(iter(d.values())), list) else (lambda kv: -kv[1])
    return [[name, v] for name, v in sorted(d.items(), key=key)[:k]]


def study(reg, name: str, *, seed: int, device, rounds: int = 3,
          profile_s: float = 4.0, plain_s: float = 8.0) -> dict:
    """One process, one profile: ``rounds`` times, ``profile_s`` seconds
    with program tracing off and on, in turns, each part between two
    marker launches (a profiler session a process, as in ``run.py``: a
    second session in one process recorded no device work in some parts,
    on an H100); then ``rounds`` times ``plain_s`` seconds unprofiled, off
    and on."""
    from portbench import inputs

    prof = tracer()
    if prof is None:
        raise SystemExit("portbench: the port has no tracer to study")
    plan = reg.plan(name)
    config, traffic, route = plan["config"], plan["traffic"], plan["route"]
    vocab = inputs.make_vocab(config["vocab"]["size"],
                              config["vocab"]["lead"], seed)
    made = route.make_inputs(config, seed, device)
    served = route.Served(config, traffic, seed, vocab, device, made)
    gen = plan["generator"]
    warm = gen.stream(traffic, vocab, inputs.sub_seed(seed, "warm"))
    for _ in range(traffic["warm_requests"]):
        served.serve(next(warm))
    calls = tr.Spans(device)
    calls.install(served.layers())
    calls.profiling = True  # wrapped calls only note their intervals
    requests = gen.stream(traffic, vocab, inputs.sub_seed(seed, "traffic"))
    order = [on for r in range(rounds)
             for on in ((False, True) if r % 2 == 0 else (True, False))]
    out = {"cell": name, "seed": seed, "profiled": [], "plain": []}
    counters, recorded = defaultdict(int), []
    profile = tr.Profile(device)
    profile.start()
    for i, on in enumerate(order):
        rec = prof.enable() if on else None
        q, n, secs = _serve_for(served, requests, profile_s)
        prof.disable()
        if i < len(order) - 1:
            profile._mark()  # the next part's start
        out["profiled"].append({"program": on, "qps": q / secs,
                                "requests": n})
        recorded.append(rec)
    profile.stop()
    doc = tr.export(profile.prof)
    del profile.prof
    marks = profile.marks
    for i, (row, rec) in enumerate(zip(out["profiled"], recorded)):
        j = join(doc, marks, rec.spans() if rec else [], calls.intervals,
                 window=(marks[i], marks[i + 1]))
        row.update(window_s=j["window_s"], busy_s=j["busy_s"])
        if rec is None:
            continue
        for k, v in rec.counters().items():
            counters[k] += v
        row.update({k: READERS[k]({"joined": j}) for k in DEVICE_READERS})
        row.update(idle=_top(j["idle"]),
                   idle_during=_top(j["idle_during"]),
                   device_by_span=_top(j["self"]),
                   device_under=_top(j["under"]))
    del doc
    own, plain_requests = defaultdict(float), 0
    for on in order:
        rec = prof.enable() if on else None
        tr.sync(device)
        q, n, secs = _serve_for(served, requests, plain_s)
        tr.sync(device)
        prof.disable()
        out["plain"].append({"program": on, "qps": q / secs, "requests": n})
        if on:
            plain_requests += n
            for k, v in self_times(rec.spans()).items():
                own[k] += v
            for k, v in rec.counters().items():
                counters[k] += v
    served.close()
    readings = {"counters": dict(counters), "plain_requests": plain_requests,
                "plain_self": dict(own)}
    out["metrics"] = {k: f(readings) for k, f in READERS.items()}
    for k in DEVICE_READERS:  # the median over the traced profiled parts
        got = [row[k] for row in out["profiled"]
               if row["program"] and row[k] is not None]
        out["metrics"][k] = statistics.median(got) if got else None
    out["counters"] = dict(counters)
    out["host_self_ms"] = _top({k: 1e3 * v / max(plain_requests, 1)
                                for k, v in own.items()}, 40)
    for key in ("profiled", "plain"):
        for on in (False, True):
            rates = [row["qps"] for row in out[key] if row["program"] is on]
            out[f"{key}_qps_{'on' if on else 'off'}"] = (
                statistics.median(rates) if rates else None)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile_s", type=float, default=4.0)
    ap.add_argument("--plain_s", type=float, default=8.0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from portbench import run

    args = parse_args(argv)
    run.set_environment()
    import torch

    torch.set_num_threads(1)
    from portbench.registry import Registry

    if not torch.cuda.is_available():
        print("portbench: the study needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = study(Registry(run.CHECKOUT), args.workload, seed=args.seed,
                device=device, rounds=args.rounds, profile_s=args.profile_s,
                plain_s=args.plain_s)
    out["device"] = run.device_info(device,
                                    int(torch.cuda.max_memory_allocated()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
