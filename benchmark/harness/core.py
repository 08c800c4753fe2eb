"""The harness core: one run of one cell.

Everything that belongs to one configuration, one cell, one entry or one
per-layer metric sits in a file of its own, found by name:

    configs/<config>.json      sizes of the model and the graph, as run
    workloads/<cell>.json      configuration, entry, traffic, limits, why
    entries/<entry>.py         ``Cell``: set-up, one timed unit, the check
    metrics/<metric>.py        ``read(ctx)``: one per-layer metric, or None
    reference/<config>.py      the configuration's plain reference

The end-to-end metrics live here.  A run: set-up (data, program, warm-up),
then timed units back to back until ``seconds`` have passed (the unit that
crosses the line ends the window), the peak memory, the check against the
reference, and one JSON line.  With ``trace`` the first units of the window
run under torch.profiler and the per-layer metrics are reported instead.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "ocn_tpu")
REGION = "bench.unit"

# the end-to-end metrics the core computes, and their units
END_TO_END = {
    "train_links_per_s": "links/s",
    "eval_links_per_s": "links/s",
    "peak_mem_gib": "GiB",
    "setup_s": "s",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    mod_name = f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_file(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: Dict, cell: str):
    """(end-to-end names, per-layer names) that ``cell`` reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    per = [m["name"] for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    return e2e, per


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card(device: str, chips: int) -> Dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, wl: Optional[Dict] = None,
        cfg: Optional[Dict] = None) -> Dict:
    """One run of cell ``name``; returns the result line's object.  ``wl``
    and ``cfg`` stand in for the cell's files (the tests' tiny sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec_file()
    wl = load_json("workloads", f"{name}.json") if wl is None else wl
    cfg = load_json("configs", f"{wl['config']}.json") if cfg is None else cfg
    entry = load_file("entries", wl["entry"])
    e2e_names, per_names = cell_metrics(spec, name)

    cell = entry.Cell(cfg, wl["traffic"], seed, device)
    spans = cell.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s: {json.dumps(spans)}")

    # with ``trace``: the first n_traced units under the profiler (device
    # activity and the host's ops: the metrics and the device operations),
    # the next one under it too with a sampler of the host's stack (what the
    # host was doing in each idle gap; no metric reads that unit)
    units, profs, counts, sampler = [], {}, None, None
    n_traced = int(wl["traffic"].get("trace_units", 1)) if trace else 0
    import torch
    log(f"load {os.getloadavg()}, cpus {len(os.sched_getaffinity(0))}, torch threads "
        f"{torch.get_num_threads()}/{torch.get_num_interop_threads()}, OMP_NUM_THREADS "
        f"{os.environ.get('OMP_NUM_THREADS')}, MKL_NUM_THREADS "
        f"{os.environ.get('MKL_NUM_THREADS')}")
    t_win = time.perf_counter()
    while True:
        i = len(units)
        kind = ("ops" if i < n_traced else "gaps" if i == n_traced else None) \
            if trace else None
        if kind is not None and kind not in profs:
            if kind == "gaps":
                profs["ops"].__exit__(None, None, None)
                counts = {k: cell.counters()[k] - v for k, v in counts.items()}
                from harness.tracing import HostSampler
                sampler = HostSampler().__enter__()
            else:
                counts = cell.counters()
            profs[kind] = _start_profile()
        t0 = time.perf_counter()
        if kind is not None:
            from torch.profiler import record_function
            with record_function(REGION):
                work = cell.unit()
                sync(device)
        else:
            work = cell.unit()
        t1 = time.perf_counter()
        units.append({"t0": t0, "t1": t1, "links": work, "traced": kind is not None})
        if kind == "gaps":
            profs["gaps"].__exit__(None, None, None)
            sampler.__exit__(None, None, None)
        if t1 - t_win >= seconds and (not trace or "gaps" in profs):
            break
    window_s = units[-1]["t1"] - t_win
    links = sum(u["links"] for u in units)
    dev = card(device, wl["chips"])
    log(f"window {window_s:.3f} s, {len(units)} units, {links} links; unit s "
        f"{[round(u['t1'] - u['t0'], 4) for u in units]}; load {os.getloadavg()}")

    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        tr = _read_trace(profs, sampler, units[n_traced]["t0"], device)
        log(f"launches in the traced units {counts}")
        ctx = {"cfg": cfg, "traffic": wl["traffic"], "stats": cell.stats,
               "units": units, "spans": spans, "trace": tr, "counters": counts,
               "n_traced": n_traced, "device": dev}
        for m in per_names:
            reader = load_file("metrics", m)
            v = reader.read(ctx)
            if v is not None:
                metrics[m] = {"value": v, "unit": reader.UNIT}
        if tr is not None:
            dev["busy_s"] = tr["busy_us"] / 1e6
            dev["window_s"] = (tr["window_us"][1] - tr["window_us"][0]) / 1e6
            breakdown = {"device_ops": tr["top"], "idle_gaps": tr["gaps"]}
    else:
        values = {"setup_s": setup_s, "peak_mem_gib": dev["memory_peak_bytes"] / 2 ** 30,
                  cell.window_metric: links / window_s}
        for m in e2e_names:
            if m in values:
                metrics[m] = {"value": values[m], "unit": END_TO_END[m]}

    cell.release()
    gc.collect()
    checks = cell.check()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {bad}")
    correct = cell.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(units),
           "failed": cell.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return out


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _read_trace(profs: Dict, sampler, t_gaps: float, device: str) -> Optional[Dict]:
    """The ops unit's trace, and the idle gaps of the gaps unit (whose
    region starts at host time ``t_gaps``) named by the sampler."""
    from harness import tracing

    if device != "cuda" or "ops" not in profs:
        return None
    t = tracing.read_profile(profs["ops"], REGION)
    t["top"] = tracing.top_kernels(t["device"])
    g = tracing.read_profile(profs["gaps"], REGION)
    lo, hi = g["window_us"]
    t["gaps"] = tracing.idle_gaps(g["device"], sampler.samples, lo, hi, lo - 1e6 * t_gaps)
    return t


def release_cuda() -> None:
    gc.collect()
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    except ImportError:
        pass


def import_reference(config: str):
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    return importlib.import_module(f"reference.{config}")
