"""Entry points: the end-to-end forward and the multi-device dry run.

Counterpart of ``__graft_entry__.py``. ``entry()`` is the flagship
CNN-BiLSTM on log-mel features (parity profile), with example arguments.

``dryrun_multichip(n)`` runs ONE data-parallel training step over n ranks:
CQCC features computed on each rank's device, the flagship model's
forward and backward with sync-BN, gradients averaged over the ranks;
with an even n, also the 2-D (data x model) component-sharded GMM scoring
against the unsharded one. The JAX package runs it over an n-device mesh
of one process; here it is n spawned processes, one device each: NCCL
ranks on n cards, or gloo ranks on the CPU when the caller asks for it.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_mel_cnn_bilstm_scorer,
)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``fn(wav)`` scores ``(8, 32000)`` waveforms on
    ``device``; weights from seed 0."""
    sr, seconds, batch = 16000, 2, 8
    mel_cfg = MelConfig(sr=sr, n_mels=64)
    model = init_mel_cnn_bilstm(mel_cfg, sr * seconds, seed=0, device=device)
    fn = make_mel_cnn_bilstm_scorer(model, mel_cfg)
    wav = np.random.default_rng(0).standard_normal((batch, sr * seconds)).astype(np.float32)
    return fn, (torch.from_numpy(wav).to(device),)


def dryrun_multichip(n_devices: int, *, device: str = "cuda", timeout: float = 600.0) -> None:
    """One sharded training step over ``n_devices`` ranks (tiny shapes).

    ``device="cuda"`` runs one NCCL process per card and raises when fewer
    than ``n_devices`` cards are visible; ``device="cpu"`` runs
    ``n_devices`` gloo processes. The ranks meet through a file in a
    temporary directory. No rank may hang: the parent joins them within
    ``timeout`` seconds, stops every rank once one has failed or the time
    is up, and raises naming the ranks that did not finish cleanly."""
    import multiprocessing as mp

    if device == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"need {n_devices} CUDA devices, found {have}; "
                f"dryrun_multichip({n_devices}, device='cpu') runs {n_devices} gloo processes"
            )
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="aad_dryrun_") as d:
        init_method = "file://" + os.path.join(d, "rendezvous")
        procs = [
            ctx.Process(target=_dryrun_rank, args=(r, n_devices, init_method, device), name=f"aad-dryrun-{r}")
            for r in range(n_devices)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break  # a failed rank leaves the others waiting in a collective
                procs[0].join(timeout=0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    bad = {p.name: p.exitcode for p in procs if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"dryrun_multichip({n_devices}, device={device!r}): ranks failed or timed out: {bad}")


def _dryrun_rank(rank: int, n_devices: int, init_method: str, device: str) -> None:
    import torch.distributed as dist

    from audioanalysisdetector_tpu_torch.parallel.mesh import initialize_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(init_method, n_devices, rank, device=device)
    try:
        _dryrun_impl(rank, n_devices, device)
    finally:
        dist.destroy_process_group()


def _dryrun_impl(rank: int, n_devices: int, device: str) -> None:
    from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc
    from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
    from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM, masked_llr
    from audioanalysisdetector_tpu_torch.models.layers import flax_init_
    from audioanalysisdetector_tpu_torch.parallel.mesh import make_mesh
    from audioanalysisdetector_tpu_torch.parallel.sharded_gmm import make_mesh_2d_for, make_sharded_masked_llr
    from audioanalysisdetector_tpu_torch.train import TrainState, get_loss, make_optimizer
    from audioanalysisdetector_tpu_torch.train.steps import make_dp_train_step, replicate, shard_batch

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    mesh = make_mesh(n_devices, axis="data")
    batch = 4 * n_devices
    n_samples = 8192  # tiny 0.5-s chunks
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((batch, n_samples)).astype(np.float32)
    labels = rng.integers(0, 2, batch)
    wav_local, y_local = shard_batch((wav, labels), mesh)
    with torch.no_grad():
        feats = cqcc(torch.from_numpy(wav_local).to(dev), CQCCConfig.for_sr(16000))  # this rank's rows
    model = CNNBiLSTMHybrid(feats.shape[-1], logits=True, bn_axis_name="data")
    flax_init_(model, torch.Generator().manual_seed(0))
    state = replicate(TrainState.create(model=model.to(dev), tx=make_optimizer("Adam", 1e-3)), mesh)
    step = make_dp_train_step(get_loss("BCELoss"), mesh, has_batch_stats=True, binary_head=True)
    generator = torch.Generator(device=dev).manual_seed(int(np.random.SeedSequence([1, rank]).generate_state(1)[0]))
    state, metrics = step(state, feats, torch.from_numpy(y_local).to(dev), generator)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if state.step != 1:
        raise AssertionError(f"step {state.step} after one step")

    # second decomposition: 2-D (data x model) mesh with the GMM mixture
    # components sharded over the model axis (cross-rank logsumexp)
    if n_devices % 2 == 0:
        mesh2d = make_mesh_2d_for(n_devices, model=2)
        d = 19

        def gmm():
            return DiagGMM(
                weights=torch.full((8,), 1 / 8, device=dev),
                means=torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)).to(dev),
                variances=torch.ones((8, d), device=dev),
            )

        g1, g2 = gmm(), gmm()
        seqs = torch.from_numpy(rng.standard_normal((batch, 7, d)).astype(np.float32)).to(dev)
        mask = torch.ones((batch, 7), dtype=torch.bool, device=dev)
        seqs, mask = shard_batch((seqs, mask), mesh2d, axis="data")
        sharded = make_sharded_masked_llr(mesh2d, g1, g2)(seqs, mask)
        ref = masked_llr(seqs, mask, g1, g2)
        np.testing.assert_allclose(sharded.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)

    if rank == 0:
        print(
            f"dryrun_multichip OK: {n_devices}-rank DP mesh on {device} (batch {batch}, "
            f"loss {loss:.4f}, acc {float(metrics['accuracy']):.3f})"
            + (", 2-D data x model GMM scoring verified" if n_devices % 2 == 0 else ""),
            flush=True,
        )
