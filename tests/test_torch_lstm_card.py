"""K4 on the card: the recurrence against its plain version and cuDNN, and its route.

``ops/lstm_scan.py::lstm_scan`` on a CUDA tensor launches K4; the plain
version (``lstm_scan_reference``, the same steps as torch operators) and
``nn.LSTM`` (cuDNN) run the same recurrence on the card, in fp32 with TF32
off. ``BiLSTM`` routes to K4 when no backward can be asked of it, so the
classifier's scores under ``inference_mode`` are compared with the same
model run with grad enabled, which keeps cuDNN.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_lstm_card.py
"""

import pytest
import torch

from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.ops import launch_counts, reset_launch_counts
from audioanalysisdetector_tpu_torch.ops import lstm_scan as k4
from audioanalysisdetector_tpu_torch.xai.attribution import inference_mode_for_grad

H = k4.HIDDEN
# K4 against the plain version, both fp32 on the card: the same steps, the
# h W_hh^T sums taken in other orders (K4: 4 slices of 32 FMAs, then a
# tree; cuBLAS its own) and the input gates shared; over 63 steps an H100
# read 1.8e-7 at most (B = 8192)
PLAIN_ATOL = 2e-6
# against cuDNN's persistent LSTM, which also rounds its own input product
# and its gates otherwise: the plain version and K4 alike read up to 8.1e-6
# from it at B = 8192, T = 63
CUDNN_ATOL = 5e-5
# the classifier's logits: fc over the last step's h (|W| ~ 0.06, 256 wide)
# of two stacked BiLSTMs, each within CUDNN_ATOL
LOGIT_ATOL = 1e-4


@pytest.fixture
def card() -> torch.device:
    """The card with TF32 off (``score/fused.py::ieee_fp32``), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(shape, seed: int, device) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(seed), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, t, i, last_only",
    [
        (8192, 63, 19, False),  # the fused cell's layer 1: both directions in one launch
        (8192, 63, 256, True),  # its layer 2: the forward scan, last step only
        (13, 1, 19, False),  # one step; a tile mostly past the batch
        (37, 5, 256, False),
        (300, 2, 19, True),
    ],
)
def test_k4_is_its_plain_version_and_cudnn(card, batch, t, i, last_only):
    torch.manual_seed(batch + t)
    lstm = torch.nn.LSTM(i, H, batch_first=True, bidirectional=not last_only).to(card)
    x = _x((batch, t, i), t, card)
    sfx = ("",) if last_only else ("", "_reverse")
    ws = tuple(getattr(lstm, f"weight_hh_l0{s}") for s in sfx)
    with torch.inference_mode():
        xg = k4.input_gates(x, lstm, sfx)
        reset_launch_counts()
        got = k4.lstm_scan(xg, ws, last_only=last_only)
        torch.cuda.synchronize()
        assert launch_counts()["lstm_scan"] == 1
        plain = k4.lstm_scan_reference(xg, ws, last_only=last_only)
        cudnn = lstm(x)[0]
    cudnn = cudnn[:, -1] if last_only else cudnn
    assert got.shape == plain.shape == cudnn.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, rtol=0, atol=PLAIN_ATOL)
    torch.testing.assert_close(got, cudnn, rtol=0, atol=CUDNN_ATOL)


def _classifier(card) -> BiLSTMClassifier:
    torch.manual_seed(5)
    return BiLSTMClassifier(hidden=H, input_dim=19).to(card).eval()


@pytest.mark.cuda
def test_classifier_scores_match_cudnn_with_two_launches(card):
    model = _classifier(card)
    x = _x((8192, 63, 19), 1, card)
    reset_launch_counts()
    with torch.inference_mode():
        k4_logits = model(x)
    torch.cuda.synchronize()
    assert launch_counts()["lstm_scan"] == 2  # layer 1's two directions, layer 2's forward scan
    reset_launch_counts()
    cudnn_logits = model(x).detach()  # grad mode: parameters require grad, so cuDNN runs
    torch.cuda.synchronize()
    assert launch_counts()["lstm_scan"] == 0
    torch.testing.assert_close(k4_logits, cudnn_logits, rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(torch.softmax(k4_logits, -1), torch.softmax(cudnn_logits, -1), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.cuda
def test_a_call_with_grad_launches_none_and_keeps_its_gradients(card):
    """An attribution's call (XAI): grad mode, the input requiring grad, the
    RNNs in training mode for cuDNN's backward (``inference_mode_for_grad``)."""
    model = _classifier(card)
    x = _x((64, 63, 19), 2, card).requires_grad_(True)
    reset_launch_counts()
    with inference_mode_for_grad(model):
        model(x).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts()["lstm_scan"] == 0
    grads = [x.grad] + [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert x.grad.abs().sum() > 0


@pytest.mark.cuda
def test_the_mel_model_keeps_cudnn(card):
    """The mel model's BiLSTM has hidden 32: the route keeps it on cuDNN."""
    model = CNNBiLSTMHybrid(63).to(card).eval()
    reset_launch_counts()
    with torch.inference_mode():
        model(_x((16, 64, 63), 3, card))
    torch.cuda.synchronize()
    assert launch_counts()["lstm_scan"] == 0
