"""Voxtral-Mini-3B read as an audio deepfake detector (PyTorch).

Mistral AI's Voxtral-Mini-3B-2507 (huggingface.co/mistralai/
Voxtral-Mini-3B-2507 ``config.json``; the Voxtral technical report, July
2025), as transformers' ``VoxtralForConditionalGeneration`` computes it in
eval mode, scored in the recipe of ALLM4ADD (2025): the model is asked
about a clip, and the score is the margin between the logits of two answer
tokens at the last prompt position.

1. The audio, as ``VoxtralProcessor`` prepares it: a clip padded to a
   multiple of 480,000 samples (30 s), one Whisper log-mel over the whole
   clip (its reflect padding at the clip's two ends only, its clip at the
   whole clip's max - 8), cut into W windows of 3,000 frames
   (``frontend/mel.py::whisper_log_mel_windows``; one K1 launch on the
   card): ``(B, W, 128, 3000)``.
2. The audio tower, Whisper large-v3's encoder
   (``models/whisper.py::WhisperEncoder``), over the ``B W`` windows as one
   batch; its final state alone (``last_state``), ``(B, W 1500, 1280)``.
3. The projector (``VoxtralMultiModalProjector``): each 4 consecutive
   frames of a window concatenated (the published ``reshape(-1, 5120)``;
   1,500 is a multiple of 4, so no group crosses a window's edge),
   ``linear_1`` 5120 -> 3072, exact GELU, ``linear_2`` 3072 -> 3072, no
   biases: 375 audio tokens a window.
4. The prompt: ``prefix_ids``, ``375 W`` placeholders of ``audio_token_id``,
   ``suffix_ids``; the token embedding of each, the placeholders' rows
   replaced in order by the projector's output (``masked_scatter``, as
   published): ``(B, T, 3072)``, ``T = prefix + 375 W + suffix``.
5. The decoder, 30 layers in Llama's equations (transformers builds it as
   ``model_type`` llama): ``h + o(Attn(RMSNorm(h)))``, then ``h +
   down(silu(gate(x)) up(x))`` with ``x = RMSNorm(h)``; 32 query heads and
   8 KV heads of 128, query head ``h`` reading KV head ``h // 4``; RoPE
   (theta 1e8) on q and k in the rotate-half convention; causal attention
   (``lm_attend``); no biases.
6. The final RMSNorm and the untied head at the last position only (the
   published ``logits_to_keep=1``): ``(B, vocab)`` logits, of which the score
   is ``logit[answer_ids[0]] - logit[answer_ids[1]]``.

Spans: ``voxtral.projector``, ``voxtral.decoder`` (the 30 layers, one
``lm.attend`` each) and ``voxtral.head``, once a call. ``work_counts()``
counts, always on, the calls of ``answer``, the windows they encoded and
the decoder positions they ran. ``VoxtralDetector()`` holds 4,676,271,104
parameters (the published 4.68 B): the encoder 636,968,960 with its
positions' table, the projector 25,165,824, the decoder's layers
3,208,826,880 and its final norm 3,072, the embedding and the head
402,653,184 each.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.frontend.mel import whisper_log_mel_windows
from audioanalysisdetector_tpu_torch.models.wav2vec2 import split_heads
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3, WhisperConfig, WhisperEncoder
from audioanalysisdetector_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class VoxtralConfig:
    audio: WhisperConfig = WHISPER_LARGE_V3
    hidden: int = 3072
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 8192
    layers: int = 30
    vocab: int = 131072
    rope_theta: float = 1e8
    eps: float = 1e-5  # rms_norm_eps
    audio_token_id: int = 24
    prefix: int = 4  # the detector's prompt: text ids before the audio
    suffix: int = 16  # and after it


# huggingface.co/mistralai/Voxtral-Mini-3B-2507 config.json (transformers'
# VoxtralEncoderConfig and VoxtralConfig._default_text_config_kwargs)
VOXTRAL_MINI_3B = VoxtralConfig()

WORK_COUNTERS = ("voxtral.calls", "voxtral.windows", "voxtral.positions")
_work = dict.fromkeys(WORK_COUNTERS, 0)
_work_lock = threading.Lock()


def work_counts() -> dict[str, int]:
    """Calls of ``VoxtralDetector.answer`` in this process, the windows they
    encoded and the decoder positions they ran."""
    with _work_lock:
        return dict(_work)


def reset_work_counts() -> None:
    with _work_lock:
        for name in _work:
            _work[name] = 0


def _count(windows: int, positions: int) -> None:
    with _work_lock:
        _work["voxtral.calls"] += 1
        _work["voxtral.windows"] += windows
        _work["voxtral.positions"] += positions


def draw_prompt_ids(cfg: VoxtralConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The detector's prompt, which no published tensor holds:
    ``prefix_ids``, ``suffix_ids`` and ``answer_ids`` (bona fide, then
    spoof), distinct ids drawn from 1,000 up (none of them
    ``audio_token_id``), on the generator's device."""
    sizes = {"prefix_ids": cfg.prefix, "suffix_ids": cfg.suffix, "answer_ids": 2}
    drawn = torch.randperm(cfg.vocab - 1000, generator=generator, device=generator.device)
    return dict(zip(sizes, (drawn[:sum(sizes.values())] + 1000).split(list(sizes.values()))))


def rope_tables(positions: int, dim: int, theta: float, device: torch.device,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE's ``(positions, dim)`` cos and sin in the rotate-half convention:
    angle ``p theta^(-2i / dim)`` for ``i < dim / 2``, repeated for the two
    halves; computed in float64 on ``device`` and rounded once
    (transformers computes the angles in float32, which is off by up to
    ~2e-4 rad at position 3,770)."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim)
    angle = torch.arange(positions, dtype=torch.float64, device=device)[:, None] * inv
    angle = torch.cat([angle, angle], dim=1)
    return angle.cos().to(dtype), angle.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x cos + rotate_half(x) sin`` over ``(B, H, T, d)`` heads, with
    ``rotate_half(x) = [-x[d/2:], x[:d/2]]``."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def lm_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: ``q`` ``(B, H, T, d)``, ``k`` and
    ``v`` ``(B, H_kv, T, d)``, query head ``h`` reading KV head ``h // (H /
    H_kv)``; ``softmax(q k^T / sqrt(d) + causal) v`` merged back to ``(B, T,
    H d)``, under the ``lm.attend`` span. K and V are expanded to ``H``
    heads first: torch's float32 fused kernel (the memory-efficient CUTLASS
    one) takes no ``enable_gqa``, which would send the call to the math path
    and its ``(B, H, T, T)`` scores. ``is_causal`` keeps it on the fused
    kernel: a float mask would be materialised."""
    b, h, t, d = q.shape
    with span("lm.attend"):
        group = h // k.shape[1]
        k, v = (y.repeat_interleave(group, dim=1) for y in (k, v))
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return a.transpose(1, 2).reshape(b, t, h * d)


class DecoderLayer(nn.Module):
    """One Llama-equation decoder layer over ``(B, T, hidden)``."""

    def __init__(self, cfg: VoxtralConfig):
        super().__init__()
        d, dh = cfg.hidden, cfg.head_dim
        self.heads, self.kv_heads = cfg.heads, cfg.kv_heads
        self.attn_norm = nn.RMSNorm(d, eps=cfg.eps)
        self.q = nn.Linear(d, cfg.heads * dh, bias=False)
        self.k = nn.Linear(d, cfg.kv_heads * dh, bias=False)
        self.v = nn.Linear(d, cfg.kv_heads * dh, bias=False)
        self.o = nn.Linear(cfg.heads * dh, d, bias=False)
        self.ffn_norm = nn.RMSNorm(d, eps=cfg.eps)
        self.gate = nn.Linear(d, cfg.ffn, bias=False)
        self.up = nn.Linear(d, cfg.ffn, bias=False)
        self.down = nn.Linear(cfg.ffn, d, bias=False)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = self.attn_norm(h)
        q = apply_rope(split_heads(self.q(x), self.heads), cos, sin)
        k = apply_rope(split_heads(self.k(x), self.kv_heads), cos, sin)
        h = h + self.o(lm_attend(q, k, split_heads(self.v(x), self.kv_heads)))
        x = self.ffn_norm(h)
        return h + self.down(F.silu(self.gate(x)) * self.up(x))


class Projector(nn.Module):
    """``(B, F, audio hidden)`` encoder frames -> ``(B, F / 4, hidden)``
    audio tokens: 4 consecutive frames concatenated, ``linear_1``, GELU,
    ``linear_2``."""

    def __init__(self, cfg: VoxtralConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.audio.ffn, cfg.hidden, bias=False)
        self.linear_2 = nn.Linear(cfg.hidden, cfg.hidden, bias=False)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        grouped = states.reshape(states.shape[0], -1, self.linear_1.in_features)
        return self.linear_2(F.gelu(self.linear_1(grouped)))


class VoxtralDetector(nn.Module):
    """``(B, n)`` 16-kHz clips, ``n`` a multiple of ``window_samples`` ->
    ``(B,)`` bona fide scores (module docstring).

    ``features`` (the whole-clip log-mel in windows), ``encode`` (the audio
    tower) and ``answer`` (projector, prompt, decoder, head) are the three
    parts ``score/e2e.py`` puts under spans. The prompt's ids are buffers,
    so a checkpoint of this model carries them."""

    def __init__(self, cfg: VoxtralConfig = VOXTRAL_MINI_3B):
        super().__init__()
        if cfg.audio.ffn % cfg.audio.hidden or cfg.audio.positions % (cfg.audio.ffn // cfg.audio.hidden):
            raise ValueError("the projector groups whole frames of a window: the tower's ffn must be a multiple "
                             "of its hidden size, and its positions a multiple of the ratio")
        self.cfg = cfg
        self.whisper = WhisperEncoder(cfg.audio)
        self.projector = Projector(cfg)
        self.embed = nn.Embedding(cfg.vocab, cfg.hidden)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.layers))
        self.norm = nn.RMSNorm(cfg.hidden, eps=cfg.eps)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab, bias=False)
        self.register_buffer("prefix_ids", torch.zeros(cfg.prefix, dtype=torch.long))
        self.register_buffer("suffix_ids", torch.zeros(cfg.suffix, dtype=torch.long))
        self.register_buffer("answer_ids", torch.zeros(2, dtype=torch.long))  # bona fide, then spoof

    @property
    def window_frames(self) -> int:
        """Mel frames a window: twice the tower's positions (the stem halves them)."""
        return 2 * self.cfg.audio.positions

    @property
    def window_samples(self) -> int:
        return self.window_frames * self.cfg.audio.mel.hop_length

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        """``(B, n)`` -> the ``(B, W, n_mels, window_frames)`` log-mel windows."""
        return whisper_log_mel_windows(wav, self.cfg.audio.mel, self.window_frames)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """``(B, W, n_mels, frames)`` -> the tower's final states of each
        clip's windows in order, ``(B, W positions, audio hidden)``."""
        b = mel.shape[0]
        return self.whisper.last_state(mel.flatten(0, 1)).view(b, -1, self.cfg.audio.hidden)

    def prompt_ids(self, audio_tokens: int) -> torch.Tensor:
        """``(T,)``: the prefix, ``audio_tokens`` placeholders, the suffix."""
        audio = torch.full((audio_tokens,), self.cfg.audio_token_id, dtype=torch.long,
                           device=self.prefix_ids.device)
        return torch.cat([self.prefix_ids, audio, self.suffix_ids])

    def embed_prompt(self, audio: torch.Tensor) -> torch.Tensor:
        """``(B, N, hidden)`` audio tokens -> the ``(B, T, hidden)`` decoder
        input: the prompt's embeddings, the placeholders' rows replaced by
        ``audio`` in order."""
        b, n, d = audio.shape
        ids = self.prompt_ids(n).expand(b, -1)
        return self.embed(ids).masked_scatter((ids == self.cfg.audio_token_id)[..., None], audio)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """The decoder's layers over ``(B, T, hidden)``, under
        ``voxtral.decoder``; RoPE's tables are built anew each call."""
        with span("voxtral.decoder"):
            cos, sin = rope_tables(x.shape[1], self.cfg.head_dim, self.cfg.rope_theta, x.device, x.dtype)
            for layer in self.layers:
                x = layer(x, cos, sin)
            return x

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The last position's final norm and logits -> ``(B,)`` answer
        margins, under ``voxtral.head``."""
        with span("voxtral.head"):
            logits = self.lm_head(self.norm(h[:, -1]))[:, self.answer_ids]
            return logits[:, 0] - logits[:, 1]

    def answer(self, states: torch.Tensor) -> torch.Tensor:
        """``encode``'s ``(B, W positions, audio hidden)`` -> ``(B,)`` scores."""
        with span("voxtral.projector"):
            audio = self.projector(states)
        x = self.embed_prompt(audio)
        b, t = x.shape[:2]
        _count(windows=b * states.shape[1] // self.cfg.audio.positions, positions=b * t)
        return self.head(self.decode(x))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.answer(self.encode(self.features(wav)))
