"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``wave_mel``     K1: mel power straight from padded waveforms (direct DFT).
- ``fused_logmel`` K2: mel power from frames gathered beforehand, f32 or
  bf16 operands (the K1 CUDA core, templated on the element type).
- ``ct_mel``       K3: mel power through a 64 x 32 Cooley-Tukey DFT of 2048
  (the parity mel step).
- ``lstm_scan``    K4: the inference LSTM recurrence (fp32) of
  ``models/lstm.py::BiLSTM``, a layer's directions in one launch: one
  kernel for hidden 128 (the fused scorer's classifier), another for
  hidden 32 (the mel model).
- ``cqcc``         K5: the CQCC of raw waveforms (CQT, dB, regrid, log,
  DCT) in one launch; ``frontend/cqcc.py::cqcc`` routes to it, and its
  plain chain is K5's plain version.
- ``gmm_llr``      K6: the fused scorer's GMM arm (padding mask, both
  GMMs' log-likelihoods, masked mean) in one launch;
  ``score/fused.py::arm_scores`` routes to it, and its ``padding_mask`` +
  ``masked_llr`` are K6's plain version.
- ``split_gemm``   K7: float32 ``x W^T`` on the tensor cores at float32
  accuracy (three bf16 planes an operand, six part products); the Voxtral
  decoder's projections route to it, and ``split_gemm_reference`` is its
  plain version.
- ``lm_attention`` K8: causal grouped-query attention in float32 on the
  tensor cores at float32 accuracy (K7's split products, an online
  softmax, each KV tile read once for the query heads that share it); the
  Voxtral decoder's ``lm_attend`` routes to it, and
  ``lm_attention_reference`` is its plain version.

Each wrapper runs its plain version on a CPU tensor (``on_card`` is False;
K5's and K6's routers keep such a tensor on their plain path themselves)
and hands a CUDA tensor's operands to ``launch``, the one launch path: it
refuses an input that needs a backward, calls the C entry point that
``_build.entry_point`` loaded on the current stream, and counts the launch
in the ledger. ``launch_counts`` and ``reset_launch_counts`` read and zero
it: each kernel's launches, ``split_gemm.planes``, K7's launches that lay
a float32 matrix out as its bf16 planes (the activations before each
product, a weight when it is first used or has changed), ``ct_mel.reflect``,
K3's launches on a raw waveform (the center reflect pad folded into its
frame addressing),
``ct_mel.db``, K3's launches that write the log-mel in dB (``power_to_db``
in its epilogue), ``lstm_scan.h32``, K4's hidden-32 kernel (its
hidden-128 kernel counts on ``lstm_scan``), and ``lm_attention.planes``,
K8's launches that lay q, k and v out as its bf16 planes. A new kernel
adds its name to ``LAUNCH_COUNTERS``.
"""

from __future__ import annotations

import threading

import torch

LAUNCH_COUNTERS = (
    "wave_mel", "fused_mel_from_frames", "ct_mel", "ct_mel.reflect", "ct_mel.db", "lstm_scan", "lstm_scan.h32",
    "cqcc", "gmm_llr", "split_gemm", "split_gemm.planes", "lm_attention", "lm_attention.planes",
)
_counts = dict.fromkeys(LAUNCH_COUNTERS, 0)
_counts_lock = threading.Lock()  # a serving thread may launch while another reads


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by counter name."""
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0


def refuse_grad(x: torch.Tensor, kernel: str) -> None:
    """Raise when autograd would need ``kernel``'s backward: grad mode is on
    and ``x`` requires grad. The hand-written kernels, like the JAX
    package's Pallas kernels, have none, and a launch through ctypes would
    cut the gradient silently (the plain versions on the CPU keep it)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{kernel}: the kernel has no backward, as the JAX package's "
            "Pallas kernels have none, and this input requires grad; run it "
            "under torch.no_grad()"
        )


def on_card(x: torch.Tensor, kernel: str) -> bool:
    """Whether ``kernel`` launches on ``x``: True on a CUDA tensor, False on
    a CPU tensor (the plain version runs); no other device has a path."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise NotImplementedError(f"{kernel} has no path for {x.device}")
    return False


def launch(entry, x: torch.Tensor, kernel: str, *args, rows: int, counters: tuple[str, ...] = ()) -> None:
    """Launch ``kernel`` on ``x``'s card: ``entry(*args, stream)`` on the
    current stream, then one count on ``kernel``'s counter and on each of
    ``counters``. ``rows``, the frame rows the kernel indexes with an int,
    must stay below 2**31."""
    refuse_grad(x, kernel)
    if rows >= 2**31:
        raise ValueError(f"{rows} frame rows overflow the kernel's int row index")
    with torch.cuda.device(x.device):
        rc = entry(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc}")
    with _counts_lock:
        for name in (kernel, *counters):
            _counts[name] += 1
