"""SSL-AASIST back end: spectro-temporal graph attention over SSL features (PyTorch).

AASIST (Jung et al., ICASSP 2022, arXiv:2110.01200) as SSL-AASIST adapts it
to wav2vec 2.0 features (github.com/TakHemlata/SSL_Anti-spoofing
``model.py``, class ``Model`` after ``ssl_model``), in eval mode, where every
dropout is an identity:

1. ``LL`` Linear(in_dim -> 128), transposed to ``(B, 1, 128, T)``,
   ``max_pool2d((3, 3))`` (``(B, 1, 42, 67)`` at T = 201), BatchNorm2d(1),
   SELU.
2. Six ``ResidualBlock`` with filters [1,32], [32,32], [32,64], [64,64] x 3:
   ``conv1`` (2, 3) pad (1, 1), BN, SELU, ``conv2`` (2, 3) pad (0, 1), plus
   the identity, through a (1, 3) ``conv_downsample`` where the width
   changes. As published, ``conv1`` reads the block's input, so ``bn1`` and
   its SELU (blocks 2-6) feed nothing: the module holds ``bn1`` for the
   checkpoint and does not compute it. AASIST's (1, 3) max-pool inside the
   block is dropped in the SSL variant, so the map stays ``(B, 64, 42, 67)``.
   Then BatchNorm2d(64), SELU.
3. ``attention`` (1x1 conv 64 -> 128, SELU, BN, 1x1 conv 128 -> 64) gives
   weights for spectral nodes (softmax over time, plus ``pos_S``) and
   temporal nodes (softmax over frequency).
4. ``GraphAttention`` on each node set (temperature 2), ``GraphPool``
   keeping the top half of the nodes by ``sigmoid(proj(h))``.
5. Two branches, each ``HeteroGraphAttention`` (64 -> 32, temperature 100,
   its own master node), a pool of each type, a second layer (32 -> 32)
   whose output is added; the elementwise max of the two branches (nodes
   paired by their rank in the last pools), then ``[max|T|, mean T,
   max|S|, mean S, master]`` into ``out_layer`` Linear(160 -> 2).

Module and parameter names are the published ones but for the encoder
(``encoder.<i>.`` here, ``encoder.<i>.0.`` there; ``convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.models.wav2vec2 import XLSR, XLSRConfig

FILTERS = ((1, 32), (32, 32), (32, 64), (64, 64), (64, 64), (64, 64))
GAT_DIMS = (64, 32)
POOL_RATIO = 0.5
TEMPERATURES = (2.0, 2.0, 100.0)
LL_DIM = 128
SPECTRAL_NODES = LL_DIM // 3  # the LL channels after the (3, 3) max-pool: 42


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, first: bool = False):
        super().__init__()
        if not first:
            self.bn1 = nn.BatchNorm2d(c_in)  # published, and unused (module docstring)
        self.conv1 = nn.Conv2d(c_in, c_out, (2, 3), padding=(1, 1))
        self.bn2 = nn.BatchNorm2d(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, (2, 3), padding=(0, 1))
        self.conv_downsample = nn.Conv2d(c_in, c_out, (1, 3), padding=(0, 1)) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.selu(self.bn2(self.conv1(x))))
        return out + (self.conv_downsample(x) if self.conv_downsample is not None else x)


def _xavier_param(rows: int) -> nn.Parameter:
    w = nn.Parameter(torch.empty(rows, 1))
    nn.init.xavier_normal_(w)
    return w


def _node_bn(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d over the features of every node of ``(B, N, D)``."""
    return bn(x.reshape(-1, x.shape[-1])).view(x.shape)


class GraphAttention(nn.Module):
    """``(B, N, in) -> (B, N, out)``: attention from the pairwise products of
    the nodes, softmaxed over the neighbours at ``temperature``."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float):
        super().__init__()
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_weight = _xavier_param(out_dim)
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)
        self.temp = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pair = torch.tanh(self.att_proj(x[:, :, None] * x[:, None]))  # (B, N, N, out)
        att = torch.softmax((pair @ self.att_weight)[..., 0] / self.temp, dim=-1)
        x = self.proj_with_att(att @ x) + self.proj_without_att(x)
        return F.selu(_node_bn(self.bn, x))


class HeteroGraphAttention(nn.Module):
    """HS-GAL: two node types with their own attention weights within and one
    across, and a master node attending to all of them."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float):
        super().__init__()
        self.proj_type1 = nn.Linear(in_dim, in_dim)
        self.proj_type2 = nn.Linear(in_dim, in_dim)
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_projM = nn.Linear(in_dim, out_dim)
        self.att_weight11 = _xavier_param(out_dim)
        self.att_weight22 = _xavier_param(out_dim)
        self.att_weight12 = _xavier_param(out_dim)
        self.att_weightM = _xavier_param(out_dim)
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.proj_with_attM = nn.Linear(in_dim, out_dim)
        self.proj_without_attM = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)
        self.temp = temperature

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, master: torch.Tensor):
        n1 = x1.shape[1]
        x = torch.cat([self.proj_type1(x1), self.proj_type2(x2)], dim=1)
        pair = torch.tanh(self.att_proj(x[:, :, None] * x[:, None]))  # (B, N, N, out)
        # all three edge weights at once; each (i, j) keeps its block's:
        # 11 within type 1, 22 within type 2, 12 across either way
        logits = pair @ torch.cat([self.att_weight11, self.att_weight22, self.att_weight12], dim=1)
        first = torch.arange(x.shape[1], device=x.device) < n1
        logits = torch.where(first[:, None] & first[None, :], logits[..., 0],
                             torch.where(~first[:, None] & ~first[None, :], logits[..., 1], logits[..., 2]))
        att = torch.softmax(logits / self.temp, dim=-1)
        att_m = torch.tanh(self.att_projM(x * master)) @ self.att_weightM  # (B, N, 1)
        att_m = torch.softmax(att_m / self.temp, dim=1)
        master = self.proj_with_attM(att_m.transpose(1, 2) @ x) + self.proj_without_attM(master)
        x = self.proj_with_att(att @ x) + self.proj_without_att(x)
        x = F.selu(_node_bn(self.bn, x))
        return x[:, :n1], x[:, n1:], master


class GraphPool(nn.Module):
    """The top half of the nodes (``POOL_RATIO``) by ``sigmoid(proj(h))``,
    each scaled by its score, in descending order of score."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        scores = torch.sigmoid(self.proj(h))  # (B, N, 1)
        k = max(int(h.shape[1] * POOL_RATIO), 1)
        idx = torch.topk(scores, k, dim=1).indices
        return torch.gather(h * scores, 1, idx.expand(-1, -1, h.shape[-1]))


class AASIST(nn.Module):
    """``(B, T, in_dim)`` SSL features -> ``(B, 2)`` logits (bona fide is 1)."""

    def __init__(self, in_dim: int = 1024):
        super().__init__()
        d0, d1 = GAT_DIMS
        self.LL = nn.Linear(in_dim, LL_DIM)
        self.first_bn = nn.BatchNorm2d(1)
        self.encoder = nn.ModuleList(ResidualBlock(a, b, first=i == 0) for i, (a, b) in enumerate(FILTERS))
        self.first_bn1 = nn.BatchNorm2d(FILTERS[-1][1])
        self.attention = nn.Sequential(nn.Conv2d(64, 128, 1), nn.SELU(), nn.BatchNorm2d(128), nn.Conv2d(128, 64, 1))
        self.pos_S = nn.Parameter(torch.randn(1, SPECTRAL_NODES, FILTERS[-1][1]))
        self.master1 = nn.Parameter(torch.randn(1, 1, d0))
        self.master2 = nn.Parameter(torch.randn(1, 1, d0))
        self.GAT_layer_S = GraphAttention(FILTERS[-1][1], d0, TEMPERATURES[0])
        self.GAT_layer_T = GraphAttention(FILTERS[-1][1], d0, TEMPERATURES[1])
        self.HtrgGAT_layer_ST11 = HeteroGraphAttention(d0, d1, TEMPERATURES[2])
        self.HtrgGAT_layer_ST12 = HeteroGraphAttention(d1, d1, TEMPERATURES[2])
        self.HtrgGAT_layer_ST21 = HeteroGraphAttention(d0, d1, TEMPERATURES[2])
        self.HtrgGAT_layer_ST22 = HeteroGraphAttention(d1, d1, TEMPERATURES[2])
        self.pool_S = GraphPool(d0)
        self.pool_T = GraphPool(d0)
        self.pool_hS1 = GraphPool(d1)
        self.pool_hT1 = GraphPool(d1)
        self.pool_hS2 = GraphPool(d1)
        self.pool_hT2 = GraphPool(d1)
        self.out_layer = nn.Linear(5 * d1, 2)

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """``(B, T, in_dim)`` -> the ``(B, 64, 42, T // 3)`` map."""
        x = F.max_pool2d(self.LL(feats).transpose(1, 2)[:, None], (3, 3))
        x = F.selu(self.first_bn(x))
        for block in self.encoder:
            x = block(x)
        return F.selu(self.first_bn1(x))

    def _branch(self, first: HeteroGraphAttention, second: HeteroGraphAttention, pool_s: GraphPool,
                pool_t: GraphPool, out_t: torch.Tensor, out_s: torch.Tensor, master: torch.Tensor):
        t, s, master = first(out_t, out_s, master)
        s, t = pool_s(s), pool_t(t)
        t_aug, s_aug, m_aug = second(t, s, master)
        return t + t_aug, s + s_aug, master + m_aug

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        """The map -> ``(B, 2)`` logits: node sets, graph layers, readout."""
        w = self.attention(x)
        e_s = (x * torch.softmax(w, dim=-1)).sum(-1).transpose(1, 2) + self.pos_S
        e_t = (x * torch.softmax(w, dim=-2)).sum(-2).transpose(1, 2)
        out_s = self.pool_S(self.GAT_layer_S(e_s))
        out_t = self.pool_T(self.GAT_layer_T(e_t))
        t1, s1, m1 = self._branch(self.HtrgGAT_layer_ST11, self.HtrgGAT_layer_ST12, self.pool_hS1,
                                  self.pool_hT1, out_t, out_s, self.master1)
        t2, s2, m2 = self._branch(self.HtrgGAT_layer_ST21, self.HtrgGAT_layer_ST22, self.pool_hS2,
                                  self.pool_hT2, out_t, out_s, self.master2)
        t, s, m = torch.maximum(t1, t2), torch.maximum(s1, s2), torch.maximum(m1, m2)
        hidden = torch.cat([t.abs().amax(1), t.mean(1), s.abs().amax(1), s.mean(1), m[:, 0]], dim=1)
        return self.out_layer(hidden)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.graph(self.encode(feats))


class SSLAASIST(nn.Module):
    """SSL-AASIST: ``(B, n)`` waveforms -> ``(B, 2)`` logits, the XLS-R
    front end (``models/wav2vec2.py``) feeding the AASIST back end. The
    published score is the bona fide logit, ``logits[:, 1]``."""

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.xlsr = XLSR(cfg)
        self.aasist = AASIST(cfg.hidden)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.aasist(self.xlsr(wav))
