"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (``setup_s``: imports, the kernels' build or its cache in
``build/kernels/``, the model and the seed's weights on the card, the
cell's inputs, the warm-up of its shapes), then the timed window of
``--seconds``, then the check against the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit, which also end
standard error. Exits non-zero without a result where there is no CUDA
device or fewer than the cell asks for, and where JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the benchmark's own folder comes first on the path,
# where its modules would shadow the standard library's; the package is
# imported from the checkout's root instead
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, spec_path=None, device="cuda") -> int:
    """One run; ``spec_path`` and ``device`` other than the defaults serve
    the tests (a spec in a temporary folder; the CPU, where no chip is
    looked for)."""
    os.environ.setdefault("USE_FLAX", "0")
    args = parse_args(argv)
    from benchmark import check, harness
    from benchmark.harness import log

    cell = harness.lookup(args.workload, spec_path)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} devices, found "
                f"{torch.cuda.device_count()}")
            return 2
        from pavenet_tpu_torch.ops import _ext
        _ext.build_all()
    driver = importlib.import_module(f"benchmark.{cell.traffic['kind']}")
    res = driver.run(cell, args, T0, device)

    numbers, limits = res["numbers"], cell.limits["numbers"]
    correct = check.verdict(numbers, cell.limits)
    checks = {k: dict(value=numbers[k], limit=limits.get(k))
              for k in numbers}
    if args.trace:
        run = dict(res["run"], device=device)
        metrics = harness.per_layer(cell, run)
    else:
        metrics = harness.end_to_end(cell, res["e2e"])
    bad = harness.forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad[:10]}")
        return 3
    out = dict(correct=bool(correct), attempted=res["attempted"],
               failed=res["failed"], metrics=metrics)
    out["device"] = (harness.device_entry(cell.chips, res["memory_peak"],
                                          res["traced"])
                     if device == "cuda" else dict(platform=str(device)))
    if args.trace:
        out["breakdown"] = dict(device_ops=res["traced"]["device_ops"],
                                idle_gaps=res["traced"]["idle_gaps"])
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
