"""What a run looks up and what it prints.

``BENCHMARK.json`` names each cell (``workloads``), its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<mix>.json``, whose ``kind`` picks the driver
``benchmark/<kind>.py``), its limits (``benchmark/limits/<cell>.json``)
and the metrics; a per-layer metric is read by
``benchmark/metrics/<metric>.py``. Nothing here names a cell, a
configuration, a mix or a metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# compared whole with the top-level name of every loaded module
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pavenet_tpu"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # benchmark/configs/<config>.json
    traffic: dict         # benchmark/traffic/<mix>.json
    limits: dict          # benchmark/limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def lookup(workload: str, spec_path: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of the spec (``BENCHMARK.json`` at the root,
    or ``spec_path``) with its files, found beside the spec under the
    benchmark's folder."""
    spec_path = Path(spec_path or ROOT / "BENCHMARK.json")
    spec = json.loads(spec_path.read_text())
    root = spec_path.parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the spec has "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench = root / Path(configs[w["config"]]["file"]).parts[0]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in names and _reports(m, workload)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, layer,
                bench)


def reader(cell: Cell, metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = cell.root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(cell: Cell, run: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell.per_layer:
        value = reader(cell, m["name"])(run)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def end_to_end(cell: Cell, values: dict) -> Dict[str, dict]:
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell.end_to_end}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0].split(",")[1].strip() if out else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_entry(chips: int, memory_peak: int,
                 traced: Optional[dict] = None) -> dict:
    import torch
    d = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
             count=chips, memory_peak_bytes=int(memory_peak),
             power_limit=power_limit())
    if traced is not None:
        d.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    return d


def machine_state() -> dict:
    """What can make two runs of the same work differ, read at one moment
    (``machine_drift`` compares two readings): this process's CPU
    seconds, the host's speed on a fixed stretch of Python (the best of
    three), and the card's SM clock, temperature, power draw and active
    throttle reasons from ``nvidia-smi``."""
    import time
    state = dict(wall=time.perf_counter(), cpu=time.process_time())
    probe = []
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(200_000))
        probe.append(time.perf_counter() - t)
    state["probe_ms"] = min(probe) * 1e3
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw,clocks_throttle_reasons.active",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()
        sm, temp, power, reasons = (v.strip() for v in out[0].split(","))
        state.update(sm_mhz=sm, temp_c=temp, power_w=power,
                     throttle=reasons)
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return state


def machine_drift(a: dict, b: dict) -> str:
    """One line on what changed from reading ``a`` to reading ``b``."""
    wall = b["wall"] - a["wall"]
    parts = [f"this process {(b['cpu'] - a['cpu']) / wall:.2f} CPU-s a s",
             f"host probe {a['probe_ms']:.2f} -> {b['probe_ms']:.2f} ms"]
    for key, unit in (("sm_mhz", " MHz SM"), ("temp_c", " C"),
                      ("power_w", " W"), ("throttle", " throttle")):
        if key in a and key in b:
            parts.append(f"{a[key]} -> {b[key]}{unit}")
    return "; ".join(parts)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def log(*args):
    print(*args, file=sys.stderr, flush=True)
