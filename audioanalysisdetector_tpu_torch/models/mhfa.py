"""Multi-head factorized attentive pooling (MHFA) over the hidden states of
a self-supervised front end.

MHFA (Peng et al., SLT 2022, arXiv:2210.01273;
github.com/JunyiPeng00/SLT22_MultiHead-Factorized-Attentive-Pooling) reads
every hidden state ``s_0 .. s_L`` of a self-supervised front end:

- keys and values from two softmax-weighted sums over the layers,
  ``K = sum_l softmax(w_k)_l s_l`` and ``V = sum_l softmax(w_v)_l s_l``;
- each compressed by its own linear layer (``cmp_linear_k``,
  ``cmp_linear_v``, hidden -> 128);
- ``att_head`` (128 -> 64 heads) and a softmax over time per head,
  ``A[t, h]``; each head pools the compressed values, ``c_h = sum_t A[t, h]
  v_t``;
- ``pooling_fc`` (64 x 128 -> 256) and an output layer (256 -> 2), whose
  second logit is the bona fide score.

``SSLMHFA`` is a front end with MHFA over its ``layers + 1`` hidden states:
``WavLMMHFA`` over WavLM-Large (``models/wav2vec2.py::WavLM``),
``W2VBertMHFA`` over w2v-BERT 2.0 (``models/w2v_bert.py::W2VBert``), 25
states each; ``WhisperMHFA`` over Whisper large-v3's encoder
(``models/whisper.py::WhisperEncoder``), 33 states of 1280. The sizes 64 / 128 / 256 and the two-way output layer are the
published code's defaults carried to this task; the pairings are this
port's.
"""

from __future__ import annotations

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.models.w2v_bert import W2V_BERT_2, W2VBert, W2VBertConfig
from audioanalysisdetector_tpu_torch.models.wav2vec2 import WAVLM_LARGE, WavLM, WavLMConfig
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3, WhisperConfig, WhisperEncoder
from audioanalysisdetector_tpu_torch.utils.profiling import span


class MHFA(nn.Module):
    """``L`` hidden states ``(B, T, hidden)`` -> ``(B, classes)`` logits."""

    def __init__(self, hidden: int = 1024, layers: int = 25, heads: int = 64, compression: int = 128,
                 outputs: int = 256, classes: int = 2):
        super().__init__()
        self.weights_k = nn.Parameter(torch.zeros(layers))
        self.weights_v = nn.Parameter(torch.zeros(layers))
        self.cmp_linear_k = nn.Linear(hidden, compression)
        self.cmp_linear_v = nn.Linear(hidden, compression)
        self.att_head = nn.Linear(compression, heads)
        self.pooling_fc = nn.Linear(heads * compression, outputs)
        self.out_layer = nn.Linear(outputs, classes)

    def forward(self, states: list[torch.Tensor]) -> torch.Tensor:
        with span("mhfa.pool"):
            mix = torch.stack([self.weights_k.softmax(0), self.weights_v.softmax(0)])  # (2, L)
            keys, values = torch.tensordot(mix, torch.stack(states), dims=1)  # each (B, T, hidden)
            v = self.cmp_linear_v(values)
            att = torch.softmax(self.att_head(self.cmp_linear_k(keys)), dim=1)  # (B, T, heads), over T
            pooled = torch.einsum("bth,btc->bhc", att, v).flatten(1)  # (B, heads x compression)
        return self.out_layer(self.pooling_fc(pooled))


class SSLMHFA(nn.Module):
    """``(B, n)`` waveforms -> ``(B, 2)`` logits: a front end (anything with
    a ``cfg`` of ``hidden`` and ``layers``, ``features(wav)`` and
    ``hidden_states(x)``), then MHFA. The front end sits under the
    attribute ``front_end_name``, so each model keeps its state-dict keys."""

    front_end_name = "front_end"

    def __init__(self, front_end: nn.Module, heads: int, compression: int, outputs: int):
        super().__init__()
        setattr(self, self.front_end_name, front_end)
        self.mhfa = MHFA(front_end.cfg.hidden, front_end.cfg.layers + 1, heads, compression, outputs)

    @property
    def front_end(self) -> nn.Module:
        return getattr(self, self.front_end_name)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        front = self.front_end
        return self.mhfa(front.hidden_states(front.features(wav)))


class WavLMMHFA(SSLMHFA):
    """WavLM-Large, then MHFA (``wavlm.*``, ``mhfa.*``)."""

    front_end_name = "wavlm"

    def __init__(self, cfg: WavLMConfig = WAVLM_LARGE, heads: int = 64, compression: int = 128, outputs: int = 256):
        super().__init__(WavLM(cfg), heads, compression, outputs)


class W2VBertMHFA(SSLMHFA):
    """w2v-BERT 2.0, then MHFA (``w2vbert.*``, ``mhfa.*``)."""

    front_end_name = "w2vbert"

    def __init__(self, cfg: W2VBertConfig = W2V_BERT_2, heads: int = 64, compression: int = 128,
                 outputs: int = 256):
        super().__init__(W2VBert(cfg), heads, compression, outputs)


class WhisperMHFA(SSLMHFA):
    """Whisper large-v3's encoder, then MHFA (``whisper.*``, ``mhfa.*``)."""

    front_end_name = "whisper"

    def __init__(self, cfg: WhisperConfig = WHISPER_LARGE_V3, heads: int = 64, compression: int = 128,
                 outputs: int = 256):
        super().__init__(WhisperEncoder(cfg), heads, compression, outputs)
