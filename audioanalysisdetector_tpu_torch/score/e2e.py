"""End-to-end scoring: waveform batch -> spoof scores (PyTorch).

Counterpart of the JAX package's ``score/e2e.py``: log-mel (a hand-written
mel kernel on CUDA) -> CNN-BiLSTM hybrid -> spoof probability, and the
flagship CQCC -> GMM ⊕ BiLSTM fused scorer, with nothing on the host
between the waveform upload and the ``(B,)`` scores. The port alone also
scores with SSL-AASIST (``models/aasist.py``): 64,600 raw samples -> XLS-R
-> AASIST -> the bona fide logit; with WavLM-Large + MHFA or w2v-BERT 2.0 +
MHFA (``models/mhfa.py``): whole 16-s clips, 256,000 samples -> the front
end's 25 hidden states -> MHFA -> the bona fide logit; and with Whisper
large-v3's encoder + MHFA: 30-s windows, 480,000 samples -> K1's log-mel ->
the encoder's 33 hidden states -> MHFA -> the bona fide logit; and with
Voxtral-Mini-3B read as a detector: whole clips of any multiple of 30 s ->
K1's log-mel of each whole clip in 30-s windows -> Whisper's encoder ->
the projector -> a 30-layer decoder -> the margin of two answer logits at
the last prompt position.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc, transpose_cqcc
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.frontend.stft import n_frames_for
from audioanalysisdetector_tpu_torch.models.aasist import SSLAASIST
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
from audioanalysisdetector_tpu_torch.models.mhfa import SSLMHFA, W2VBertMHFA, WavLMMHFA, WhisperMHFA
from audioanalysisdetector_tpu_torch.models.voxtral import VoxtralDetector, draw_prompt_ids
from audioanalysisdetector_tpu_torch.models.w2v_bert import W2VBert
from audioanalysisdetector_tpu_torch.models.wav2vec2 import XLSR, WavLM
from audioanalysisdetector_tpu_torch.models.whisper import WhisperEncoder
from audioanalysisdetector_tpu_torch.score.fused import fused_scores, ieee_fp32
from audioanalysisdetector_tpu_torch.utils.profiling import span

# SSL-AASIST's input: 64,600 samples (4.04 s) at 16 kHz, the published
# ``pad`` length (score/streaming.py::tile_pad)
XLSR_AASIST_SR = 16000
XLSR_AASIST_SAMPLES = 64600
# WavLM-Large + MHFA's input: 256,000 samples (16.0 s) at 16 kHz, whole
# clips within WavLM's relative-position horizon (800 frames)
WAVLM_MHFA_SR = 16000
WAVLM_MHFA_SAMPLES = 256000
# w2v-BERT 2.0 + MHFA's input: the same 16.0-s clips (T = 799 feature rows)
W2VBERT_MHFA_SR = 16000
W2VBERT_MHFA_SAMPLES = 256000
# Whisper large-v3 + MHFA's input: one 30-s window, 480,000 samples at 16
# kHz (3,000 mel frames, 1,500 positions), as the published extractor pads
# or trims every clip
WHISPER_MHFA_SR = 16000
WHISPER_MHFA_SAMPLES = 480000
# Voxtral's input: 16-kHz clips of any multiple of 480,000 samples (30 s),
# as VoxtralProcessor pads them
VOXTRAL_SR = 16000


def melspec_features(wav: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    """(B, n) -> (B, n_mels, T) log-mel feature maps."""
    return log_mel_spectrogram(wav, mel_cfg)


def _init_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation, drawn from ``generator``: uniform in
    +-1/sqrt(fan_in) for conv and dense layers, +-1/sqrt(H) for the LSTM;
    norm layers keep weight 1, bias 0."""
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.Linear)):
            fan_in = mod.weight[0].numel()
            bounds = {"weight": fan_in**-0.5, "bias": fan_in**-0.5}
        elif isinstance(mod, torch.nn.LSTM):
            bounds = {n: mod.hidden_size**-0.5 for n, _ in mod.named_parameters()}
        else:
            continue
        with torch.no_grad():
            for name, b in bounds.items():
                getattr(mod, name).uniform_(-b, b, generator=generator)


def _checkpoint_state(checkpoint: str) -> dict[str, torch.Tensor]:
    """A ``.msgpack`` payload of the JAX package's ``save_checkpoint``
    (read without msgpack or flax, converted from the flax layout), or a
    ``torch.save`` state dict (the port's own format)."""
    if checkpoint.endswith(".msgpack"):
        from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm
        from audioanalysisdetector_tpu_torch.train.checkpoint import load_payload

        payload = load_payload(checkpoint)
        return flax_to_torch_cnn_bilstm(
            {"params": payload["params"], "batch_stats": payload.get("batch_stats")}
        )
    return torch.load(checkpoint, map_location="cpu", weights_only=True)


def init_mel_cnn_bilstm(
    mel_cfg: MelConfig,
    n_samples: int,
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> CNNBiLSTMHybrid:
    """The flagship mel model in eval mode on ``device`` (the card unless the
    caller names another) — the one place the
    checkpoint contract lives: parameters AND trained BatchNorm statistics
    travel together (inference needs both).

    Parameters are drawn from ``torch.Generator().manual_seed(seed)``. With
    ``checkpoint`` — a JAX ``fit()`` payload (``best_model.msgpack``) or a
    state dict saved by ``torch.save`` — its weights replace them; when it
    carries no BatchNorm statistics the initial ones stay, as in the JAX
    package."""
    t_frames = n_frames_for(n_samples, mel_cfg.hop_length, mel_cfg.n_fft, mel_cfg.center)
    model = CNNBiLSTMHybrid(t_frames)
    _init_params(model, torch.Generator().manual_seed(seed))
    if checkpoint:
        missing, unexpected = model.load_state_dict(_checkpoint_state(checkpoint), strict=False)
        bn_stats = {"bn.running_mean", "bn.running_var", "bn.num_batches_tracked"}
        if unexpected or set(missing) - bn_stats:
            raise ValueError(
                f"checkpoint {checkpoint} does not fit the model: missing "
                f"{sorted(set(missing) - bn_stats)}, unexpected {sorted(unexpected)}"
            )
    return model.to(device).eval()


def make_mel_cnn_bilstm_scorer(
    model: CNNBiLSTMHybrid,
    mel_cfg: MelConfig = MelConfig(sr=16000, n_mels=64),
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n_samples) -> (B,)`` spoof scores (sigmoid head), on the
    model's device, under ``torch.inference_mode()``. The waveforms are
    cast to ``compute_dtype`` before the mel (float32, or bfloat16: K1's
    bf16 route on the card); the features reach the model in float32.

    Parity mode is full fp32: this calls ``ieee_fp32`` (TF32 off for the
    whole process)."""
    ieee_fp32()
    model.eval()

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                feats = melspec_features(wav.to(compute_dtype), mel_cfg)
            with span("score.model"):
                out = model(feats.float())
                return out.reshape(out.shape[0])

    return score


def make_cqcc_fused_scorer(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    cqcc_cfg: CQCCConfig = CQCCConfig(),
    *,
    scaler_mean: np.ndarray | torch.Tensor | None = None,
    scaler_std: np.ndarray | torch.Tensor | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n_samples) -> (B,)`` fused GMM ⊕ BiLSTM scores from raw audio,
    on the device of the model and GMMs, under ``torch.inference_mode()``
    with TF32 off: CQCC -> transpose -> scale -> fuse (the reference's full
    scoring path) with no per-sample host round-trip."""
    if (scaler_mean is None) != (scaler_std is None):
        # half a scaler silently skips standardization and every
        # downstream score is quietly wrong
        raise ValueError("pass BOTH scaler_mean and scaler_std, or neither")
    ieee_fp32()
    model.eval()
    device = gmm_genuine.means.device
    scale = None
    if scaler_mean is not None:
        scale = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)
                      for a in (scaler_mean, scaler_std))

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                feats = transpose_cqcc(cqcc(wav, cqcc_cfg))  # (B, T, 19)
                if scale is not None:
                    feats = (feats - scale[0]) / scale[1]
            with span("score.model"):
                return fused_scores(model, gmm_genuine, gmm_spoof, feats)

    return score


def _init_front_end(xlsr: XLSR, generator: torch.Generator) -> None:
    """fairseq's initialisation of an XLS-R or WavLM front end past
    torch's defaults, drawn from ``generator``: Kaiming normal conv
    encoder, ``init_bert_params`` N(0, 0.02) for the transformer's linear
    layers (WavLM's gate ``grep_linear`` among them) with zero biases, the
    positional conv N(0, sqrt(4 / (k * hidden))) with zero bias; WavLM's
    bias embedding N(0, 1), its ``grep_a`` left at ones."""
    cfg = xlsr.cfg
    with torch.no_grad():
        for conv in xlsr.conv.convs:
            conv.weight.normal_(0.0, (2.0 / conv.weight[0].numel()) ** 0.5, generator=generator)
        for layer in xlsr.layers:
            for lin in layer.modules():
                if isinstance(lin, torch.nn.Linear):
                    lin.weight.normal_(0.0, 0.02, generator=generator)
                    lin.bias.zero_()
        xlsr.pos_conv.weight.normal_(0.0, (4.0 / (cfg.pos_kernel * cfg.hidden)) ** 0.5, generator=generator)
        xlsr.pos_conv.bias.zero_()
        if isinstance(xlsr, WavLM):
            xlsr.rel_attn_embed.weight.normal_(generator=generator)


def _init_uniform(model: torch.nn.Module, generator: torch.Generator) -> None:
    """torch's default bounds for every conv and dense layer of ``model``,
    drawn from ``generator``: uniform in +-1/sqrt(fan_in)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)):
                bound = mod.weight[0].numel() ** -0.5
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)


def _init_ssl_aasist(model: SSLAASIST, generator: torch.Generator) -> None:
    """Initialisation scales of the published code, drawn from ``generator``:
    fairseq's for XLS-R (``_init_front_end``), torch's defaults for
    ``proj`` and the back end (uniform +-1/sqrt(fan_in), Xavier-normal
    attention weights, N(0, 1) ``pos_S`` and master nodes); norms keep
    weight 1, bias 0 and unit running statistics."""
    _init_uniform(model, generator)
    _init_front_end(model.xlsr, generator)
    with torch.no_grad():
        for name, p in model.aasist.named_parameters():
            if name.startswith(("pos_S", "master")):
                p.normal_(generator=generator)
            elif "att_weight" in name:
                p.normal_(0.0, (2.0 / (p.shape[0] + 1)) ** 0.5, generator=generator)


def init_xlsr_aasist(
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> SSLAASIST:
    """SSL-AASIST at its published widths in eval mode on ``device``.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` at the
    published initialisation scales. With ``checkpoint`` — the published
    ``Model.state_dict()`` (``LA_model.pth``; converted by
    ``convert.ssl_aasist_to_port``) or a ``torch.save`` state dict of this
    model — its tensors replace them and must fit exactly."""
    from audioanalysisdetector_tpu_torch.convert import ssl_aasist_to_port

    model = SSLAASIST()
    _init_ssl_aasist(model, torch.Generator().manual_seed(seed))
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if any(k.startswith(("ssl_model.", "module.ssl_model.")) for k in state):
            state = ssl_aasist_to_port(state)
        model.load_state_dict(state)
    return model.to(device).eval()


def make_xlsr_aasist_scorer(model: SSLAASIST) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, 64600) -> (B,)`` bona fide logits (``logits[:, 1]``, the score
    the published ``produce_evaluation_file`` writes), on the model's
    device, under ``torch.inference_mode()`` with TF32 off (``ieee_fp32``).
    Spans: ``xlsr.features`` and ``xlsr.encoder`` inside ``score.frontend``,
    ``aasist.graph`` (node sets to readout) inside ``score.model``."""
    ieee_fp32()
    model.eval()

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                with span("xlsr.features"):
                    feats = model.xlsr.features(wav)
                with span("xlsr.encoder"):
                    feats = model.xlsr.encode(feats)
            with span("score.model"):
                x = model.aasist.encode(feats)
                with span("aasist.graph"):
                    return model.aasist.graph(x)[:, 1]

    return score


def init_wavlm_mhfa(
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> WavLMMHFA:
    """WavLM-Large + MHFA at the published widths in eval mode on ``device``.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` at the
    published initialisation scales: fairseq's for the front end
    (``_init_front_end``), torch's defaults for ``proj`` and MHFA's linear
    layers, MHFA's layer weights zero (a uniform mix). With ``checkpoint``:
    the published front end (huggingface.co/microsoft/wavlm-large
    ``pytorch_model.bin``, converted by ``convert.wavlm_to_port``) replaces
    the front end and keeps the seeded back end; a ``torch.save`` state dict
    of this model replaces every tensor. Either must fit exactly."""
    from audioanalysisdetector_tpu_torch.convert import wavlm_to_port

    model = WavLMMHFA()
    generator = torch.Generator().manual_seed(seed)
    _init_uniform(model, generator)
    _init_front_end(model.wavlm, generator)
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "wavlm.conv.convs.0.weight" in state:
            model.load_state_dict(state)
        else:
            model.wavlm.load_state_dict(wavlm_to_port(state))
    return model.to(device).eval()


def _make_scorer(model: torch.nn.Module, first: tuple[str, Callable], second: tuple[str, Callable],
                 head: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n) -> (B,)`` scores of a front end in two named halves and a
    head, on the model's device, under ``torch.inference_mode()`` with TF32
    off (``ieee_fp32``): ``first`` from the waveform and ``second`` to the
    states, each under its span inside ``score.frontend``; ``head`` from the
    states to the scores inside ``score.model``."""
    ieee_fp32()
    model.eval()

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                with span(first[0]):
                    feats = first[1](wav)
                with span(second[0]):
                    states = second[1](feats)
            with span("score.model"):
                return head(states)

    return score


def _make_mhfa_scorer(model: SSLMHFA, first: tuple[str, Callable], second: tuple[str, Callable]
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``_make_scorer`` of a front end + MHFA: the bona fide logits
    (``logits[:, 1]``; ``mhfa.pool``) as the head."""
    return _make_scorer(model, first, second, lambda states: model.mhfa(states)[:, 1])


def make_wavlm_mhfa_scorer(model: WavLMMHFA) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, 256000) -> (B,)`` bona fide logits (``_make_mhfa_scorer``).
    Spans: ``wavlm.features`` and ``wavlm.encoder`` (which holds
    ``wavlm.position_bias`` once and ``wavlm.gated_bias`` once a layer)
    inside ``score.frontend``, ``mhfa.pool`` inside ``score.model``."""
    return _make_mhfa_scorer(model, ("wavlm.features", model.wavlm.features),
                             ("wavlm.encoder", model.wavlm.hidden_states))


def _init_w2vbert(w2vbert: W2VBert, generator: torch.Generator) -> None:
    """transformers' ``Wav2Vec2BertPreTrainedModel._init_weights`` past
    torch's defaults, drawn from ``generator``: the layers' linear layers
    N(0, 0.02) with zero biases, the convolution module's convs (the
    pointwise ones Conv1d of kernel 1 there) Kaiming normal over their fan
    in, the feature projection uniform in +-1/sqrt(160); norms weight 1,
    bias 0; ``distance_embedding`` keeps torch's N(0, 1)."""
    with torch.no_grad():
        for layer in w2vbert.layers:
            conv = layer.conv_module
            for mod in layer.modules():
                if isinstance(mod, torch.nn.Linear) and mod.bias is not None:
                    mod.weight.normal_(0.0, 0.02, generator=generator)
                    mod.bias.zero_()
            for w in (conv.pointwise1.weight, conv.pointwise2.weight, conv.depthwise.weight):
                w.normal_(0.0, (2.0 / w[0].numel()) ** 0.5, generator=generator)
            layer.distance_embedding.weight.normal_(generator=generator)


def init_w2vbert_mhfa(
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> W2VBertMHFA:
    """w2v-BERT 2.0 + MHFA at the published widths in eval mode on ``device``.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` at the
    published initialisation scales: transformers' for the front end
    (``_init_w2vbert``), torch's defaults for MHFA's linear layers, MHFA's
    layer weights zero (a uniform mix). With ``checkpoint``: the published
    front end (huggingface.co/facebook/w2v-bert-2.0 ``model.safetensors``
    saved as a ``torch.save`` state dict, converted by
    ``convert.w2vbert_to_port``) replaces the front end and keeps the seeded
    back end; a ``torch.save`` state dict of this model replaces every
    tensor. Either must fit exactly."""
    from audioanalysisdetector_tpu_torch.convert import w2vbert_to_port

    model = W2VBertMHFA()
    generator = torch.Generator().manual_seed(seed)
    _init_uniform(model, generator)
    _init_w2vbert(model.w2vbert, generator)
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "w2vbert.proj.weight" in state:
            model.load_state_dict(state)
        else:
            model.w2vbert.load_state_dict(w2vbert_to_port(state))
    return model.to(device).eval()


def make_w2vbert_mhfa_scorer(model: W2VBertMHFA) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, 256000) -> (B,)`` bona fide logits (``_make_mhfa_scorer``).
    Spans: ``w2vbert.fbank`` (the Kaldi filterbank) and ``w2vbert.encoder``
    (the projection and the 24 layers, holding ``w2vbert.rel_key`` and
    ``w2vbert.conv_module`` once a layer) inside ``score.frontend``,
    ``mhfa.pool`` inside ``score.model``."""
    w2vbert = model.w2vbert
    return _make_mhfa_scorer(model, ("w2vbert.fbank", w2vbert.fbank),
                             ("w2vbert.encoder", lambda feats: w2vbert.hidden_states(w2vbert.project(feats))))


def _init_whisper(whisper: WhisperEncoder, generator: torch.Generator) -> None:
    """transformers' ``WhisperPreTrainedModel._init_weights`` past torch's
    defaults, drawn from ``generator``: every conv and linear layer of the
    encoder N(0, 0.02) with zero biases; norms weight 1, bias 0; the
    positions keep their sinusoids."""
    with torch.no_grad():
        for mod in whisper.modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Linear)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()


def init_whisper_mhfa(
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> WhisperMHFA:
    """Whisper large-v3's encoder + MHFA at the published widths in eval
    mode on ``device``.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` at the
    published initialisation scales: transformers' for the encoder
    (``_init_whisper``), torch's defaults for MHFA's linear layers, MHFA's
    layer weights zero (a uniform mix). With ``checkpoint``: the published
    encoder (huggingface.co/openai/whisper-large-v3 ``model.safetensors``
    saved as a ``torch.save`` state dict, the decoder's tensors not taken;
    converted by ``convert.whisper_to_port``) replaces the encoder and keeps
    the seeded back end; a ``torch.save`` state dict of this model replaces
    every tensor. Either must fit exactly."""
    from audioanalysisdetector_tpu_torch.convert import whisper_to_port

    model = WhisperMHFA()
    generator = torch.Generator().manual_seed(seed)
    _init_uniform(model.mhfa, generator)
    _init_whisper(model.whisper, generator)
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "whisper.conv1.weight" in state:
            model.load_state_dict(state)
        else:
            model.whisper.load_state_dict(whisper_to_port(state))
    return model.to(device).eval()


def make_whisper_mhfa_scorer(model: WhisperMHFA) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, 480000) -> (B,)`` bona fide logits (``_make_mhfa_scorer``).
    Spans: ``whisper.log_mel`` (the center pad, one K1 launch on the card,
    the normalisation) and ``whisper.encoder`` (``whisper.conv_stem``, the
    positions and the 32 layers) inside ``score.frontend``, ``mhfa.pool``
    inside ``score.model``."""
    whisper = model.whisper
    return _make_mhfa_scorer(model, ("whisper.log_mel", whisper.features),
                             ("whisper.encoder", whisper.hidden_states))


def _init_voxtral(model: VoxtralDetector, generator: torch.Generator) -> None:
    """transformers' ``VoxtralPreTrainedModel._init_weights``, drawn from
    ``generator``: every conv and linear layer and the token embedding N(0,
    0.02), biases zero; LayerNorms and RMSNorms weight 1 (bias 0); the
    positions keep their sinusoids. The prompt's ids are drawn too
    (``draw_prompt_ids``)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Linear, torch.nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
        for name, ids in draw_prompt_ids(model.cfg, generator).items():
            getattr(model, name).copy_(ids)


def init_voxtral_detect(
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> VoxtralDetector:
    """Voxtral-Mini-3B as a detector at the published widths in eval mode,
    built on ``device``.

    Parameters are drawn from a generator on ``device`` seeded with
    ``seed`` at the published initialisation scales (``_init_voxtral``),
    and the prompt's ids with them. With ``checkpoint``: the published model
    (huggingface.co/mistralai/Voxtral-Mini-3B-2507 as a ``torch.save`` state
    dict, converted by ``convert.voxtral_to_port``) replaces every weight
    and keeps the seeded prompt; a ``torch.save`` state dict of this model
    replaces every tensor, the prompt's ids among them. Either must fit
    exactly."""
    from audioanalysisdetector_tpu_torch.convert import voxtral_to_port

    with torch.device(device):
        model = VoxtralDetector()
        _init_voxtral(model, torch.Generator(device=device).manual_seed(seed))
    if checkpoint:
        state = torch.load(checkpoint, map_location=device, weights_only=True)
        if "whisper.conv1.weight" not in state:
            prompt = {k: getattr(model, k) for k in ("prefix_ids", "suffix_ids", "answer_ids")}
            state = {**voxtral_to_port(state), **prompt}
        model.load_state_dict(state)
    return model.eval()


def make_voxtral_detect_scorer(model: VoxtralDetector) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n) -> (B,)`` bona fide scores, ``n`` a multiple of 480,000
    (``_make_scorer``). Spans: ``whisper.log_mel`` (the whole-clip log-mel
    in windows: the center pad, one K1 launch over the B clips on the card,
    each clip's max) and ``whisper.encoder`` (the B W windows in one batch:
    ``whisper.conv_stem``, the positions, the 32 layers, each under
    ``ssl.attend``) inside ``score.frontend``; ``voxtral.projector``, the
    prompt's embedding and splice, ``voxtral.decoder`` (30 ``lm.attend``)
    and ``voxtral.head`` inside ``score.model``."""
    return _make_scorer(model, ("whisper.log_mel", model.features), ("whisper.encoder", model.encode),
                        model.answer)


def make_e2e_train_step_inputs(wav: torch.Tensor, cqcc_cfg: CQCCConfig) -> torch.Tensor:
    """Featurize waveforms for the flagship trainer: (B, n) -> (B, 19, T)."""
    return cqcc(wav, cqcc_cfg)
