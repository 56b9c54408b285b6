#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's kernels built or loaded from ``build/``, weights and
inputs made from ``--seed``, the cell's shapes warmed) is timed from the
start of this process to the window. The window runs ``--seconds``; the
outputs it produced are then held to the plain reference. With ``--trace
1`` the window runs under ``torch.profiler`` and the result carries the
cell's per-layer metrics, the device's busy time and a breakdown.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, optionally
``breakdown``, and last ``checks`` (each number compared, with its limit),
which also close standard error. No result is printed, and the exit code
is not 0, when the card or cards the cell needs are missing or when
``jax``, ``jaxlib``, ``flax`` or ``audioanalysisdetector_tpu`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "audioanalysisdetector_tpu")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc builds already go to ``build/torch_kernels``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the port must not use."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness.cells import load_cell
    from portbench.harness.report import report

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 3
    result, lines = report(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           device="cuda", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
