"""The fused scorer's GMM arm in one launch: the hand-written Hopper kernel (K6).

The JAX package has no Pallas GMM (XLA computes it); this kernel replaces
the port's plain arm on the card, ``score/fused.py::padding_mask`` then
``models/gmm.py::masked_llr`` (per GMM two SGEMMs and some ten passes over
whole ``(N, K)`` matrices), where ``takes`` holds of the input. From the
frames ``(B, T, D)`` and the two ``DiagGMM``s it computes, per utterance,
the mean of ``LL_spoof - LL_genuine`` over the frames whose coefficient sum
is non-zero (0 where there is none) and whether there is none: the
``llr_spoof`` and ``empty`` of ``arm_scores``. Both GMMs' tables are built
in shared memory in each block's prologue from the raw weights, means and
variances, so nothing is cached between calls. Design and bound: the note
in ``ops/csrc/gmm_llr.cu``.

``gmm_llr`` launches the kernel on a CUDA tensor, counted as ``gmm_llr``
(its caller's ``fused.gmm`` span covers the launch). There is no
fallback: a failed build or a refused launch raises. The plain version is
``arm_scores``' own path,
``masked_llr(x, padding_mask(x), spoof, genuine)``: on an input
``refusals`` names a reason for, ``arm_scores`` runs it.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable

import torch

from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card, refuse_grad

# the shared-memory plan: both GMMs' tables, 2 K (2 D + 1) floats with D and
# K padded, take at most 133 KB at these bounds (ops/csrc/gmm_llr.cu)
MAX_DIM = 32
MAX_COMPONENTS = 256
# gmm_llr_launch(x, n_rows, T, D, w0, mu0, var0, k0, w1, mu1, var1, k1, llr, empty, stream)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)


def _params(*gmms: DiagGMM) -> list[torch.Tensor]:
    return [t for g in gmms for t in (g.weights, g.means, g.variances)]


def refusals(
    x: torch.Tensor, gmm_genuine: DiagGMM, gmm_spoof: DiagGMM, feature_fn: Callable | None = None
) -> list[str]:
    """Why the kernel cannot compute ``arm_scores``' GMM arm of ``x``, each
    reason by name, or an empty list: it takes ``(B, T, D)`` float32 frames
    on the card with both GMMs' float32 parameters on the same card, of
    matching shapes, D <= 32 and K <= 256 (the shared-memory plan), no
    ``gmm_feature_fn`` (the mask then comes from other frames than the
    GMMs'), and no backward (autograd would need one when grad mode is on
    and ``x`` or a parameter requires grad)."""
    params = _params(gmm_spoof, gmm_genuine)
    why = []
    if not x.is_cuda or any(p.device != x.device for p in params):
        why.append("device")
    if x.dtype != torch.float32 or any(p.dtype != torch.float32 for p in params):
        why.append("dtype")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() != 3 or any(
        g.means.dim() != 2 or g.means.shape != g.variances.shape or g.means.shape[1] != d
        or g.weights.shape != g.means.shape[:1] or not g.n_components
        for g in (gmm_spoof, gmm_genuine)
    ):
        why.append("shape")
    if not 1 <= d <= MAX_DIM:
        why.append("dim")
    if any(g.n_components > MAX_COMPONENTS for g in (gmm_spoof, gmm_genuine)):
        why.append("components")
    if feature_fn is not None:
        why.append("feature_fn")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        why.append("grad")
    return why


def takes(
    x: torch.Tensor, gmm_genuine: DiagGMM, gmm_spoof: DiagGMM, feature_fn: Callable | None = None
) -> bool:
    """Whether ``arm_scores`` computes the GMM arm of ``x`` through the kernel."""
    return not refusals(x, gmm_genuine, gmm_spoof, feature_fn)


def gmm_llr(x: torch.Tensor, gmm_spoof: DiagGMM, gmm_genuine: DiagGMM) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, T, D)`` float32 frames on the card -> ``(llr_spoof (B,), empty
    (B,) bool)``: the masked mean of ``LL_spoof - LL_genuine`` over the
    frames whose coefficient sum is non-zero, and whether an utterance has
    no such frame; one launch of the kernel on the current stream, counted
    as ``gmm_llr``. Call it where ``takes`` holds."""
    if not on_card(x, "gmm_llr"):
        raise ValueError("the GMM kernel runs on the card: arm_scores computes a CPU tensor")
    why = [r for r in refusals(x, gmm_genuine, gmm_spoof) if r not in ("device", "grad")]  # launch raises on grad
    if why:
        raise ValueError(f"the GMM kernel cannot take this input: {', '.join(why)}")
    params = _params(gmm_spoof, gmm_genuine)
    if any(p.device != x.device for p in params):
        raise ValueError("the GMM kernel needs both GMMs on the frames' card")
    for p in params:
        refuse_grad(p, "gmm_llr")
    x = x.contiguous()
    params = [p.contiguous() for p in params]
    B, T, D = x.shape
    llr = x.new_empty(B)
    empty = torch.empty(B, dtype=torch.bool, device=x.device)
    if not B:
        return llr, empty
    w0, mu0, var0, w1, mu1, var1 = (p.data_ptr() for p in params)
    launch(
        _build.entry_point("gmm_llr", "gmm_llr_launch", _ARGTYPES), x, "gmm_llr",
        x.data_ptr(), B, T, D, w0, mu0, var0, gmm_spoof.n_components,
        w1, mu1, var1, gmm_genuine.n_components, llr.data_ptr(), empty.data_ptr(),
        rows=B,
    )
    return llr, empty
