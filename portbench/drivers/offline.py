"""Offline scoring: batches of device-resident waveforms dispatched back to
back through the system's scorer, the scores kept on the device and read
once the window has closed.

Traffic parameters: ``batch`` (utterances a call), ``pool_batches``
(distinct seeded batches, cycled), ``audio`` (the waveform recipe).
End-to-end: ``score_utt_per_s``, every utterance scored over the whole
window, which ends in one synchronisation. ``correct``: every score of
every batch the window produced against the float64 reference of its
batch, but for the utterances the reference leaves out (``evaluate``).
"""

from __future__ import annotations

import time

import torch

from portbench.harness import audio
from portbench.harness.result import Outcome, device_ms, sync
from portbench.harness.trace import Window


def inputs(cell, system, seed: int, device: str) -> tuple[dict, dict, list[torch.Tensor]]:
    """(weights, aux, pool of batches), all made on ``device`` from ``seed``."""
    cfg, tr = cell.config, cell.traffic
    g = audio.seed_generator(seed, device)
    weights = system.make_weights(cfg, g, device, tr["audio"])
    aux = system.make_aux(cfg, g, device, tr["audio"])
    pool = [audio.waves(int(tr["batch"]), cfg["n_samples"], cfg["sr"], g, device, tr["audio"])
            for _ in range(int(tr["pool_batches"]))]
    return weights, aux, pool


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> Outcome:
    cfg, batch = cell.config, int(cell.traffic["batch"])
    system = cell.system()
    weights, aux, pool = inputs(cell, system, seed, device)
    program = system.build(cfg, weights, aux, device)
    for _ in range(2):  # the one shape of the cell: kernel build, constants, cuDNN plans
        program.score(pool[0])
    sync(device)
    setup_s = time.perf_counter() - t_start

    outs = []
    with Window(trace, device) as window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            outs.append(program.score(pool[len(outs) % len(pool)]))
        sync(device)
        elapsed = time.perf_counter() - t0
    scored = len(outs) * batch
    out = Outcome(setup_s=setup_s, attempted=scored)
    out.end_to_end["score_utt_per_s"] = scored / elapsed
    out.note_memory(device)
    if trace:
        out.trace = window.summary
        feats = program.frontend(pool[0])
        out.context.update(rate_utt_per_s=scored / elapsed, utterances_per_call=batch,
                           frontend_ms=device_ms(lambda: program.frontend(pool[0]), device),
                           model_ms=device_ms(lambda: program.model(feats), device))
        del feats
    del program
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()

    ref = cell.reference()
    worst, bad, left_out = 0.0, 0, 0
    refs = [ref.evaluate(cfg, weights, wav, aux=aux) for wav in pool]
    for i, s in enumerate(outs):
        exact, compared = refs[i % len(pool)]
        gap = (s.double() - exact).abs()
        gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))[compared]
        worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        bad += int((gap > cfg["limits"]["score_gap"]).sum())
        left_out += int((~compared).sum())
    out.failed = bad
    out.context["left_out"] = f"{left_out} answers" if left_out else None
    out.check("score_gap", worst, cfg["limits"]["score_gap"])
    return out


def control(cell, seed: int, device: str) -> dict[str, float]:
    """The numbers compared, read off the control: the reference at float32
    with TF32 on in the program's place, on the inputs of ``seed``."""
    from portbench.reference.common import precision

    ref = cell.reference()
    weights, aux, pool = inputs(cell, cell.system(), seed, device)
    worst = 0.0
    for wav in pool:
        exact, compared = ref.evaluate(cell.config, weights, wav, aux=aux)
        with precision(tf32=True):
            low = ref.scores(cell.config, weights, wav, aux=aux, dtype=torch.float32)
        worst = max(worst, float((low.double() - exact).abs()[compared].max()))
    return {"score_gap": worst}
