"""Plain reference of Voxtral-Mini-3B read as a detector: whole clips ->
Whisper's log-mel of each whole clip in 30-s windows -> Whisper large-v3's
encoder -> the projector -> the 30-layer decoder -> the margin of two
answer logits at the last prompt position.

Written from transformers' Voxtral equations (``VoxtralProcessor`` with
``WhisperFeatureExtractor``, ``VoxtralEncoder``,
``VoxtralMultiModalProjector``, and the ``LlamaForCausalLM`` that
``VoxtralConfig``'s text config builds; the shape of
huggingface.co/mistralai/Voxtral-Mini-3B-2507 ``config.json``), in eval
mode, in plain PyTorch, in the dtype of the waveform:

- the log-mel of the whole clip, ``reference/whisper_mhfa.py::log_mel``
  over all its samples: reflect padding of 200 samples at the clip's two
  ends only, the explicit windowed DFT, the last frame dropped, the clip at
  the whole clip's max - 8; its frames then cut into windows of 3,000;
- each window through the encoder (``whisper_mhfa``'s stem, sinusoids, 32
  layers with explicit softmax attention, the final LayerNorm), in blocks
  of windows, the final state alone;
- the projector: frames ``4 j .. 4 j + 3`` of a window concatenated in
  that order, ``linear_1``, exact GELU, ``linear_2``, no biases;
- the sequence, concatenated: the embedding rows of the prefix ids, the
  clip's audio tokens window by window, the embedding rows of the suffix
  ids;
- 30 layers: ``RMSNorm(x) = x / sqrt(mean(x^2) + eps) w``; q, k and v with
  no biases; RoPE in the rotate-half convention, the angle of position
  ``p`` and pair ``i`` being ``p theta^(-2 i / 128)`` in the input's dtype;
  query head ``h`` reading KV head ``h // 4`` by an explicit index; ``q
  k^T / sqrt(128)``, minus infinity where the key comes after the query,
  softmax, times v (in blocks of heads); ``o``; the residual; then
  ``down(silu(gate x) up x)`` on the second RMSNorm, and the residual;
- the final RMSNorm at the last position, and the two answer rows of
  ``lm_head``: their logits' difference.

Departures from the published model: the prompt's ids are seeded, not a
tokenized instruction; only the last position's logits of the two answer
ids are computed (the published head computes the whole vocabulary, and
a chat model would generate); there is no LoRA or fine-tuned head, and the
two answer rows are calibrated (``configs/voxtral-detect.json``
``assumed``, ``systems/voxtral_detect.py``); the published extractor
rounds its spectrum to complex64 and its features to float32, and
transformers computes RoPE's angles in float32, where this keeps the
waveform's dtype throughout. The positions' table is computed here, not
read from ``weights``.

``weights`` is the benchmark's dict of tensors under the port's names
(``whisper.*``, ``projector.*``, ``embed.weight``, ``layers.*``,
``norm.weight``, ``lm_head.weight``, and the ids ``prefix_ids``,
``suffix_ids``, ``answer_ids``). Each weight is cast to the computing
dtype as it is used, so on the card at most one layer's weights are held in
float64 beside the program's float32 ones; the embedding and the head give
only the rows the prompt and the answers read. Nothing here imports the
port. The score is smooth everywhere, so every answer is compared.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.whisper_mhfa import attention as encoder_attention
from portbench.reference.whisper_mhfa import conv_stem, log_mel, sinusoids
from portbench.reference.xlsr_aasist import _w, gelu, layer_norm, linear

ENCODER_WINDOWS = 5  # windows a block through the encoder
HEADS_A_BLOCK = 8  # query heads a block of the decoder's attention


def windows(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, W, window_frames, n_mels)``: the whole clip's
    log-mel, its frames cut into windows."""
    mel = log_mel(wav, cfg)
    b, t, m = mel.shape
    return mel.view(b, t // cfg["window_frames"], cfg["window_frames"], m)


def encoder_state(mel: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(N, frames, n_mels)`` windows -> the final LayerNorm of layer 32's
    output, ``(N, positions, hidden)``."""
    eps = cfg["ln_eps"]
    h = conv_stem(mel, weights)
    h = h + sinusoids(h.shape[1], h.shape[2], cfg, h)
    for n in range(cfg["layers"]):
        p = f"whisper.layers.{n}"
        h = h + linear(encoder_attention(layer_norm(h, weights, f"{p}.attn_norm", eps), weights, p, cfg), weights,
                       f"{p}.out")
        x = layer_norm(h, weights, f"{p}.ffn_norm", eps)
        h = h + linear(gelu(linear(x, weights, f"{p}.fc1")), weights, f"{p}.fc2")
    return layer_norm(h, weights, "whisper.norm", eps)


def audio_tokens(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, W positions / 4, lm_hidden)``: each window's
    final states, 4 consecutive frames concatenated, through the
    projector."""
    mel = windows(wav, cfg)
    b, w = mel.shape[:2]
    flat = mel.reshape(b * w, *mel.shape[2:])
    states = torch.cat([encoder_state(flat[i:i + ENCODER_WINDOWS], weights, cfg)
                        for i in range(0, b * w, ENCODER_WINDOWS)])
    n, t, d = states.shape
    per = cfg["ffn"] // cfg["hidden"]  # frames a token: the published reshape to (-1, ffn)
    grouped = states.reshape(n, t // per, per * d).reshape(b, w * t // per, per * d)
    x = gelu(grouped @ _w(weights, "projector.linear_1.weight", wav).T)
    return x @ _w(weights, "projector.linear_2.weight", wav).T


def table_rows(weights: dict, name: str, ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of the table ``name``, in ``like``'s dtype."""
    return weights[name][ids.to(weights[name].device)].to(like.device, like.dtype)


def rms_norm(x: torch.Tensor, weights: dict, name: str, eps: float) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * _w(weights, name, x)


def rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """RoPE over ``(B, H, T, d)``: ``x cos + [-x2, x1] sin`` with angles
    ``p theta^(-2 i / d)`` repeated over the two halves."""
    d = x.shape[-1]
    inv = cfg["rope_theta"] ** (-torch.arange(0, d, 2, device=x.device, dtype=x.dtype) / d)
    angle = torch.arange(x.shape[2], device=x.device, dtype=x.dtype)[:, None] * inv
    angle = torch.cat([angle, angle], dim=1)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * torch.cos(angle) + rotated * torch.sin(angle)


def attention(x: torch.Tensor, weights: dict, p: str, cfg: dict) -> torch.Tensor:
    """One layer's causal grouped-query attention over the normed ``x``
    ``(B, T, lm_hidden)``, before ``o``: ``(B, T, heads head_dim)``."""
    b, t, _ = x.shape
    heads, kv, dh = cfg["lm_heads"], cfg["lm_kv_heads"], cfg["lm_head_dim"]

    def project(name: str, n: int) -> torch.Tensor:
        return (x @ _w(weights, f"{p}.{name}.weight", x).T).reshape(b, t, n, dh).transpose(1, 2)

    q, k, v = rope(project("q", heads), cfg), rope(project("k", kv), cfg), project("v", kv)
    group = torch.arange(heads, device=x.device) // (heads // kv)  # query head h reads KV head h // 4
    later = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    out = []
    for h0 in range(0, heads, HEADS_A_BLOCK):
        g = group[h0:h0 + HEADS_A_BLOCK]
        logits = (q[:, h0:h0 + HEADS_A_BLOCK] @ k[:, g].transpose(-1, -2) / math.sqrt(dh)).masked_fill(
            later, float("-inf"))
        out.append(torch.softmax(logits, dim=-1) @ v[:, g])
    return torch.cat(out, dim=1).transpose(1, 2).reshape(b, t, heads * dh)


def final_state(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> the final RMSNorm of the last position, ``(B,
    lm_hidden)``."""
    eps = cfg["rms_eps"]
    audio = audio_tokens(wav, weights, cfg)
    b = audio.shape[0]
    prefix, suffix = (table_rows(weights, "embed.weight", weights[k], wav).expand(b, -1, -1)
                      for k in ("prefix_ids", "suffix_ids"))
    h = torch.cat([prefix, audio, suffix], dim=1)
    for n in range(cfg["lm_layers"]):
        p = f"layers.{n}"
        h = h + attention(rms_norm(h, weights, f"{p}.attn_norm.weight", eps), weights, p, cfg) @ _w(
            weights, f"{p}.o.weight", h).T
        x = rms_norm(h, weights, f"{p}.ffn_norm.weight", eps)
        gate = x @ _w(weights, f"{p}.gate.weight", x).T
        h = h + (gate * torch.sigmoid(gate) * (x @ _w(weights, f"{p}.up.weight", x).T)) @ _w(
            weights, f"{p}.down.weight", x).T
    return rms_norm(h[:, -1], weights, "norm.weight", eps)


def margins(state: torch.Tensor, weights: dict) -> torch.Tensor:
    """``(B, lm_hidden)`` final states -> ``(B,)`` ``logit[bona fide] -
    logit[spoof]``."""
    head = table_rows(weights, "lm_head.weight", weights["answer_ids"], state)
    logits = state @ head.T
    return logits[:, 0] - logits[:, 1]


def evaluate(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
             rows: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` clips -> (``(B,)`` scores in ``dtype``, ``(B,)`` all True:
    every answer is compared), a clip at a time by default."""
    out = torch.cat([margins(final_state(wav[i:i + rows].to(dtype), weights, cfg), weights)
                     for i in range(0, wav.shape[0], rows)])
    return out, torch.ones_like(out, dtype=torch.bool)


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 1) -> torch.Tensor:
    """``(B, n)`` clips -> ``(B,)`` scores in ``dtype``."""
    return evaluate(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)[0]
