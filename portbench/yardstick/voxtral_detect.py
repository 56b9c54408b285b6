"""Operations and bytes of Voxtral-Mini-3B read as a detector, from the
configuration's shapes alone.

As ``counts.py`` counts: one operation is one add or one multiply; a layer
counts what its mathematics needs (2 per weight a position for every linear
layer and convolution; 2 per product term for ``Q K^T`` and ``A V``);
elementwise work (norms, GELU, SiLU, RoPE, the softmaxes, the log-mel's
normalisation) is left out. The log-mel counts every frame K1 computes over
the whole clip (``counts.mel_frame_ops``), the dropped last one too. The
encoder counts as ``whisper_mhfa.py`` counts a 30-s window, once a window;
the decoder's attention counts the causal pairs, ``T (T + 1) / 2`` a head,
and the head one position.
"""

from __future__ import annotations

from portbench.yardstick import counts
from portbench.yardstick import whisper_mhfa as whisper
from portbench.yardstick.xlsr_aasist import TF32_FLOP_PER_S

__all__ = ["audio_tokens", "decoder_layer_ops", "encoder_ops", "head_ops", "lm_attention_bound", "logmel_ops",
           "positions", "projector_ops", "score_ops", "windows"]


def _window(cfg: dict) -> dict:
    """The configuration read as one 30-s window (``whisper_mhfa.py``'s
    ``n_samples``)."""
    return {**cfg, "n_samples": cfg["window_frames"] * cfg["hop_length"]}


def windows(cfg: dict) -> int:
    """30-s windows a clip."""
    return cfg["n_samples"] // (cfg["window_frames"] * cfg["hop_length"])


def audio_tokens(cfg: dict) -> int:
    """Projector outputs a clip: a window's positions over the frames a
    token (``ffn / hidden``, the published reshape)."""
    return windows(cfg) * whisper.positions(_window(cfg)) // (cfg["ffn"] // cfg["hidden"])


def positions(cfg: dict) -> int:
    """Decoder positions a clip: the prompt around the audio tokens."""
    return cfg["prompt_prefix"] + audio_tokens(cfg) + cfg["prompt_suffix"]


def logmel_ops(cfg: dict) -> float:
    """One clip's log-mel: every frame of the centred STFT of the whole clip."""
    return counts.frames(cfg["n_samples"], cfg["hop_length"]) * counts.mel_frame_ops(cfg)


def encoder_ops(cfg: dict) -> float:
    """One clip's windows through the stem and the encoder's layers."""
    win = _window(cfg)
    return windows(cfg) * (whisper.stem_ops(win) + cfg["layers"] * sum(whisper.layer_ops(win).values()))


def projector_ops(cfg: dict) -> float:
    """One clip's audio tokens through ``linear_1`` and ``linear_2``."""
    d = cfg["lm_hidden"]
    return audio_tokens(cfg) * 2.0 * (cfg["ffn"] * d + d * d)


def decoder_layer_ops(cfg: dict) -> dict[str, float]:
    """One clip through one decoder layer, by part."""
    t, d = positions(cfg), cfg["lm_hidden"]
    q, kv = cfg["lm_heads"] * cfg["lm_head_dim"], cfg["lm_kv_heads"] * cfg["lm_head_dim"]
    pairs = t * (t + 1) / 2
    return {"attn_proj": 2.0 * t * d * (2 * q + 2 * kv), "ffn": 3 * 2.0 * t * d * cfg["lm_ffn"],
            "attention": 2 * 2.0 * pairs * q}  # Q K^T and A V over the causal pairs of every head


def head_ops(cfg: dict) -> float:
    """The head at the last position: every logit of the vocabulary."""
    return 2.0 * cfg["vocab"] * cfg["lm_hidden"]


def score_ops(cfg: dict) -> float:
    """One clip through the scorer: the log-mel, the encoder, the projector,
    the decoder, the head."""
    return (logmel_ops(cfg) + encoder_ops(cfg) + projector_ops(cfg)
            + cfg["lm_layers"] * sum(decoder_layer_ops(cfg).values()) + head_ops(cfg))


def lm_attention_bound(cfg: dict, rows: int) -> dict:
    """The least time the card could take for a call's decoder attention,
    all ``lm_layers`` layers over ``rows`` clips: ``Q K^T`` and ``A V`` over
    the causal pairs at the TF32 dense tensor peak, or Q, K, V (``lm_kv_heads``
    heads, each read once) and the output read or written once at the memory
    peak: the larger (``whisper_mhfa.py::attention_bound``'s rule)."""
    from portbench.yardstick.peaks import HBM_BYTES_PER_S

    t = positions(cfg)
    q, kv = cfg["lm_heads"] * cfg["lm_head_dim"], cfg["lm_kv_heads"] * cfg["lm_head_dim"]
    ops = cfg["lm_layers"] * rows * decoder_layer_ops(cfg)["attention"]
    nbytes = cfg["lm_layers"] * 4 * rows * t * (2 * q + 2 * kv)
    ops_s, bytes_s = ops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}
