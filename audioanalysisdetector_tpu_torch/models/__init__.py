"""Models (PyTorch): the CNN-BiLSTM hybrid, the fused system's BiLSTM
classifier, the diagonal GMM (scoring, EM, MAP), their LSTM layers, the
anti-spoofing ResNet family, MobileNetV2 + MFCA, SSL-AASIST (the XLS-R
front end and the AASIST graph-attention back end), and WavLM-Large,
w2v-BERT 2.0 and Whisper large-v3's encoder with multi-head factorized
attentive pooling (MHFA)."""

from audioanalysisdetector_tpu_torch.models.aasist import AASIST, SSLAASIST
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import (
    DiagGMM,
    component_log_prob,
    compute_llr,
    fit_em,
    from_numpy,
    log_weighted,
    map_adapt,
    masked_llr,
    predict_proba,
    score,
    score_samples,
    to_numpy,
)
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM, LSTMLayer
from audioanalysisdetector_tpu_torch.models.mhfa import MHFA, SSLMHFA, W2VBertMHFA, WavLMMHFA, WhisperMHFA
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import (
    MFCAModule,
    MobileNetMFCA,
    MobileNetV2Features,
)
from audioanalysisdetector_tpu_torch.models.resnet import (
    AntiSpoofingResNet,
    ExtractFeatureResidual,
    MoreFeaturesClassifier,
    ResidualBlock,
    ResNetTrunk,
)
from audioanalysisdetector_tpu_torch.models.w2v_bert import W2V_BERT_2, ConformerLayer, W2VBert, W2VBertConfig
from audioanalysisdetector_tpu_torch.models.wav2vec2 import WAVLM_LARGE, XLSR, WavLM, WavLMConfig, XLSRConfig
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3, WhisperConfig, WhisperEncoder

__all__ = [
    "AASIST",
    "AntiSpoofingResNet",
    "BiLSTM",
    "BiLSTMClassifier",
    "CNNBiLSTMHybrid",
    "ConformerLayer",
    "DiagGMM",
    "ExtractFeatureResidual",
    "LSTMLayer",
    "MFCAModule",
    "MHFA",
    "MobileNetMFCA",
    "MobileNetV2Features",
    "MoreFeaturesClassifier",
    "ResNetTrunk",
    "ResidualBlock",
    "SSLAASIST",
    "SSLMHFA",
    "W2VBert",
    "W2VBertConfig",
    "W2VBertMHFA",
    "W2V_BERT_2",
    "WAVLM_LARGE",
    "WavLM",
    "WavLMConfig",
    "WavLMMHFA",
    "WHISPER_LARGE_V3",
    "WhisperConfig",
    "WhisperEncoder",
    "WhisperMHFA",
    "XLSR",
    "XLSRConfig",
    "component_log_prob",
    "compute_llr",
    "fit_em",
    "flax_init_",
    "from_numpy",
    "log_weighted",
    "map_adapt",
    "masked_llr",
    "predict_proba",
    "score",
    "score_samples",
    "to_numpy",
]
