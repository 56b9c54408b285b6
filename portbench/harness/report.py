"""One run of a cell, from its driver to the result object and the lines
that close standard error."""

from __future__ import annotations

import json

import torch

from portbench.harness.cells import Cell, metric_reader
from portbench.harness.result import line
from portbench.yardstick.peaks import power_limit


def device_info(out, cell: Cell, device: str) -> dict:
    cuda = str(device).startswith("cuda")
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    if out.trace is not None:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
    return info


def per_layer(out, cell: Cell) -> dict[str, tuple[float, str]]:
    """The cell's per-layer metrics that their readers found something for."""
    ctx = {"config": cell.config, "traffic": cell.traffic, "trace": out.trace,
           "score_ops": getattr(cell.system(), "score_ops", None), **out.context}
    found = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            found[m["name"]] = (float(value), m["unit"])
    return found


def report(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
           t_start: float) -> tuple[dict, list[str]]:
    """Run ``cell`` once; (the result object, the closing lines for stderr)."""
    out = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace, device=device, t_start=t_start)
    if trace:
        metrics = per_layer(out, cell)
    else:
        values = {"setup_s": out.setup_s, **out.end_to_end}
        metrics = {m["name"]: (values[m["name"]], m["unit"]) for m in cell.end_to_end}
    breakdown = None
    if out.trace is not None:
        breakdown = {"device_ops": out.trace.device_ops, "idle_gaps": out.trace.idle_gaps}
    result = line(out, metrics, device_info(out, cell, device), breakdown)
    lines = [f"portbench: {cell.name} seed={seed} card: {power_limit() if device != 'cpu' else 'cpu'}"]
    if out.context.get("left_out"):
        lines.append(f"left out of the comparison by the reference's rule: {out.context['left_out']}")
    if out.context.get("readings"):
        lines.append("readings: " + json.dumps(out.context["readings"]))
    lines.append(f"correct: {result['correct']}")
    lines += [f"check {name}: {value!r} limit {limit!r} -> {'ok' if value <= limit else 'FAIL'}"
              for name, value, limit in out.checks]
    return result, lines
