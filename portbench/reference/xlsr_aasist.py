"""Plain reference of SSL-AASIST: waveform -> XLS-R 300M -> AASIST -> the
bona fide logit.

Written from the published description (Tak et al., arXiv:2202.12233,
github.com/TakHemlata/SSL_Anti-spoofing ``model.py``; fairseq's
``Wav2Vec2Model`` as ``xlsr2_300m.pt`` configures it, the shape of
huggingface.co/facebook/wav2vec2-xls-r-300m ``config.json``), in eval mode,
in plain PyTorch, in the dtype of the waveform:

- XLS-R: seven strided convolutions over the raw samples (an explicit
  unfold and product), each with LayerNorm over the channels and exact
  GELU; LayerNorm and the projection to 1024; the grouped positional
  convolution (kernel 128, 16 groups, padding 64, its last frame dropped),
  GELU, added; 24 pre-LayerNorm layers with ``softmax(Q K^T / sqrt(64)) V``
  over 16 heads and a GELU feed-forward; the final LayerNorm;
- AASIST: the 128-wide linear map, a (3, 3) max-pool, BatchNorm and SELU;
  six residual blocks whose first convolution reads the block's input (so
  ``bn1`` feeds nothing, as published); BatchNorm, SELU; the spectral and
  temporal node sets from the 1x1 attention map; graph attention with
  temperatures, top-k graph pooling, two heterogeneous stacking branches
  with master nodes, their elementwise max, the readout and the output
  layer. Every BatchNorm uses its running statistics.

``weights`` is the benchmark's dict of tensors under the port's parameter
names (``xlsr.*``, ``aasist.*``). ``calibrate`` runs the same forward pass
with each BatchNorm taking its batch's statistics and each graph pool's
projection set from its inputs, writing both into ``weights``
(``systems/xlsr_aasist.py``). Nothing here imports the port.

Top-k pooling is the one discontinuity: where two pool scores that decide
the answer nearly tie, the last bit of the input picks which node is kept
or which comes first. ``evaluate`` breaks each such near tie the other way
and leaves the utterance out of the comparison where that moves the answer
(``cfg["compare"]``, below).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import in_blocks

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def _w(weights: dict, name: str, like: torch.Tensor) -> torch.Tensor:
    return weights[name].to(like.device, like.dtype)


def layer_norm(x: torch.Tensor, weights: dict, name: str, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, then the affine."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * _w(weights, f"{name}.weight", x) + _w(weights, f"{name}.bias", x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: ``x Phi(x)``."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x > 0, x, SELU_ALPHA * (torch.exp(torch.clamp(x, max=0.0)) - 1.0))


def linear(x: torch.Tensor, weights: dict, name: str) -> torch.Tensor:
    return x @ _w(weights, f"{name}.weight", x).T + _w(weights, f"{name}.bias", x)


def conv_frames(x: torch.Tensor, weights: dict, name: str, stride: int) -> torch.Tensor:
    """A Conv1d with bias over time-major ``(B, T, C_in)``, no padding:
    ``(B, T', C_out)``."""
    w = _w(weights, f"{name}.weight", x)  # (C_out, C_in, k)
    cols = x.unfold(1, w.shape[-1], stride)  # (B, T', C_in, k)
    return torch.einsum("btck,ock->bto", cols, w) + _w(weights, f"{name}.bias", x)


def pos_conv(x: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """The grouped positional convolution over ``(B, T, D)``, padding k/2 on
    both sides and the last output frame dropped: ``(B, T, D)``."""
    w = _w(weights, "xlsr.pos_conv.weight", x)  # (D, D / g, k)
    b = _w(weights, "xlsr.pos_conv.bias", x)
    k, g = cfg["pos_kernel"], cfg["pos_groups"]
    t, d = x.shape[1], x.shape[2]
    cols = F.pad(x, (0, 0, k // 2, k // 2)).unfold(1, k, 1)[:, :t]  # (B, T, D, k)
    per = d // g
    out = [torch.einsum("btck,ock->bto", cols[:, :, j * per:(j + 1) * per], w[j * per:(j + 1) * per])
           for j in range(g)]
    return torch.cat(out, dim=-1) + b


def xlsr(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, T, hidden)`` XLS-R features."""
    eps = cfg["ln_eps"]
    x = wav[:, :, None]
    for i, stride in enumerate(cfg["conv_strides"]):
        x = gelu(layer_norm(conv_frames(x, weights, f"xlsr.conv.convs.{i}", stride), weights,
                            f"xlsr.conv.norms.{i}", eps))
    h = linear(layer_norm(x, weights, "xlsr.feature_norm", eps), weights, "xlsr.proj")
    h = h + gelu(pos_conv(h, weights, cfg))
    b, t, d = h.shape
    heads = cfg["heads"]
    dh = d // heads
    for n in range(cfg["layers"]):
        p = f"xlsr.layers.{n}"
        x = layer_norm(h, weights, f"{p}.attn_norm", eps)
        q, k, v = (linear(x, weights, f"{p}.{m}").reshape(b, t, heads, dh).transpose(1, 2) for m in "qkv")
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        h = h + linear((att @ v).transpose(1, 2).reshape(b, t, d), weights, f"{p}.out")
        h = h + linear(gelu(linear(layer_norm(h, weights, f"{p}.ffn_norm", eps), weights, f"{p}.fc1")),
                       weights, f"{p}.fc2")
    return layer_norm(h, weights, "xlsr.norm", eps)


class _Pass:
    """One forward pass of the back end: plain, or calibrating (each
    BatchNorm takes its batch's mean and biased variance and writes them
    into ``weights``; each pool's projection is set from its inputs), and
    the pools' smallest gaps between the scores that decide the answer."""

    def __init__(self, weights: dict, cfg: dict, calibrate: bool = False, swap_at: str | None = None):
        self.weights, self.cfg, self.calibrate = weights, cfg, calibrate
        self.swap_at = swap_at  # the pool whose near ties this pass breaks the other way
        self.gaps: list[torch.Tensor] = []  # (B,) per pool: the smallest deciding gap

    def bn(self, x: torch.Tensor, name: str, axes: tuple[int, ...]) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[1] = -1
        if self.calibrate:
            mean = x.mean(dim=axes)
            var = ((x - mean.view(shape)) ** 2).mean(dim=axes)
            self.weights[f"{name}.running_mean"] = mean.to(self.weights[f"{name}.running_mean"].dtype)
            self.weights[f"{name}.running_var"] = var.to(self.weights[f"{name}.running_var"].dtype)
        w = self.weights
        mean, var = _w(w, f"{name}.running_mean", x).view(shape), _w(w, f"{name}.running_var", x).view(shape)
        scale, shift = _w(w, f"{name}.weight", x).view(shape), _w(w, f"{name}.bias", x).view(shape)
        return (x - mean) / torch.sqrt(var + self.cfg["bn_eps"]) * scale + shift

    def node_bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.bn(x.reshape(-1, x.shape[-1]), name, (0,)).view(x.shape)

    def conv2d(self, x: torch.Tensor, name: str, padding: tuple[int, int]) -> torch.Tensor:
        w = _w(self.weights, f"{name}.weight", x)  # (O, I, kh, kw)
        o, _, kh, kw = w.shape
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
        hh, ww = x.shape[2] - kh + 1, x.shape[3] - kw + 1
        cols = F.unfold(x, (kh, kw))  # (B, I kh kw, H' W')
        out = w.reshape(o, -1) @ cols + _w(self.weights, f"{name}.bias", x)[:, None]
        return out.view(x.shape[0], o, hh, ww)

    def gat(self, x: torch.Tensor, name: str, temp: float) -> torch.Tensor:
        w = self.weights
        pair = torch.tanh(linear(x[:, :, None] * x[:, None], w, f"{name}.att_proj"))
        att = torch.softmax((pair @ _w(w, f"{name}.att_weight", x))[..., 0] / temp, dim=-1)
        x = linear(att @ x, w, f"{name}.proj_with_att") + linear(x, w, f"{name}.proj_without_att")
        return selu(self.node_bn(x, f"{name}.bn"))

    def htrg(self, x1: torch.Tensor, x2: torch.Tensor, master: torch.Tensor, name: str, temp: float):
        w = self.weights
        n1 = x1.shape[1]
        x = torch.cat([linear(x1, w, f"{name}.proj_type1"), linear(x2, w, f"{name}.proj_type2")], dim=1)
        pair = torch.tanh(linear(x[:, :, None] * x[:, None], w, f"{name}.att_proj"))
        att = torch.empty(pair.shape[:3], dtype=x.dtype, device=x.device)
        for rows, cols, which in ((slice(None, n1), slice(None, n1), "11"), (slice(n1, None), slice(n1, None), "22"),
                                  (slice(None, n1), slice(n1, None), "12"), (slice(n1, None), slice(None, n1), "12")):
            att[:, rows, cols] = (pair[:, rows, cols] @ _w(w, f"{name}.att_weight{which}", x))[..., 0]
        att = torch.softmax(att / temp, dim=-1)
        att_m = torch.tanh(linear(x * master, w, f"{name}.att_projM")) @ _w(w, f"{name}.att_weightM", x)
        att_m = torch.softmax(att_m[..., 0] / temp, dim=-1)  # (B, N)
        master = linear(att_m[:, None] @ x, w, f"{name}.proj_with_attM") + linear(master, w, f"{name}.proj_without_attM")
        x = linear(att @ x, w, f"{name}.proj_with_att") + linear(x, w, f"{name}.proj_without_att")
        x = selu(self.node_bn(x, f"{name}.bn"))
        return x[:, :n1], x[:, n1:], master

    def pool(self, h: torch.Tensor, name: str, *, ordered: bool) -> torch.Tensor:
        """The top half of the nodes by ``sigmoid(proj(h))``, scaled by their
        scores, in descending order. ``ordered``: the order of the kept
        nodes reaches the answer (the branches' elementwise max pairs them
        by rank), so every gap among them counts, not only the k-th."""
        w = self.weights
        n = h.shape[1]
        k = max(int(n * self.cfg["pool_ratio"]), 1)
        if self.calibrate:
            self._set_pool(h, name, k)
        scores = torch.sigmoid(linear(h, w, f"{name}.proj"))[..., 0]  # (B, N)
        top = torch.topk(scores, k + 1, dim=1)
        gap = top.values[:, :-1] - top.values[:, 1:]  # (B, k): rank r minus rank r + 1
        ranks = range(k) if ordered else range(k - 1, k)
        self.gaps.append(gap[:, ranks.start:].amin(1))
        idx = top.indices
        if name.endswith(f".{self.swap_at}"):
            idx = _swap_near_ties(idx, gap, ranks, self.cfg["compare"]["min_topk_gap"])
        return torch.gather(h * scores[..., None], 1, idx[:, :k, None].expand(-1, -1, h.shape[-1]))

    def _set_pool(self, h: torch.Tensor, name: str, k: int) -> None:
        """Point ``proj`` where the nodes of an utterance differ most: the
        top eigenvector of the within-utterance covariance of ``h``, signed
        as the drawn vector. Along it the scores spread most against the
        rounding of ``h``, so fewer of them nearly tie. Scale it so its
        logits spread by ``pool_logit_std`` within an utterance, and shift
        it so the boundary between the k-th and the (k+1)-th node lies at 0
        on average, where the sigmoid is steepest."""
        w = self.weights
        dt = w[f"{name}.proj.weight"].dtype
        centred = (h - h.mean(1, keepdim=True)).reshape(-1, h.shape[-1])
        v = torch.linalg.eigh(centred.T @ centred)[1][:, -1]
        v = torch.where(v @ w[f"{name}.proj.weight"].to(h.dtype)[0] < 0, -v, v)
        z = h @ v
        scale = self.cfg["pool_logit_std"] / float(z.std(dim=1).mean())
        mid = float(torch.topk(z, k + 1, dim=1).values[:, k - 1:].mean())
        w[f"{name}.proj.weight"] = (v * scale)[None].to(dt)
        w[f"{name}.proj.bias"] = torch.full_like(w[f"{name}.proj.bias"], -mid * scale)

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"aasist.encoder.{i}"
        out = self.conv2d(selu(self.bn(self.conv2d(x, f"{p}.conv1", (1, 1)), f"{p}.bn2", (0, 2, 3))),
                          f"{p}.conv2", (0, 1))
        identity = self.conv2d(x, f"{p}.conv_downsample", (0, 1)) if f"{p}.conv_downsample.weight" in self.weights else x
        return out + identity

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        """``(B, T, hidden)`` -> ``(B, 2)`` logits."""
        cfg, w = self.cfg, self.weights
        t_s, t_h = cfg["temperatures"][0], cfg["temperatures"][2]
        x = linear(feats, w, "aasist.LL").transpose(1, 2)[:, None]  # (B, 1, 128, T)
        b, _, f, t = x.shape
        x = x[:, :, :f // 3 * 3, :t // 3 * 3].reshape(b, 1, f // 3, 3, t // 3, 3).amax(dim=(3, 5))
        x = selu(self.bn(x, "aasist.first_bn", (0, 2, 3)))
        for i in range(len(cfg["filters"])):
            x = self.block(x, i)
        x = selu(self.bn(x, "aasist.first_bn1", (0, 2, 3)))
        a = selu(self.conv2d(x, "aasist.attention.0", (0, 0)))
        a = self.conv2d(self.bn(a, "aasist.attention.2", (0, 2, 3)), "aasist.attention.3", (0, 0))
        e_s = (x * torch.softmax(a, dim=-1)).sum(-1).transpose(1, 2) + _w(w, "aasist.pos_S", x)
        e_t = (x * torch.softmax(a, dim=-2)).sum(-2).transpose(1, 2)
        out_s = self.pool(self.gat(e_s, "aasist.GAT_layer_S", t_s), "aasist.pool_S", ordered=False)
        out_t = self.pool(self.gat(e_t, "aasist.GAT_layer_T", cfg["temperatures"][1]), "aasist.pool_T",
                          ordered=False)
        branches = []
        for j in (1, 2):
            master = _w(w, f"aasist.master{j}", x)
            tt, ss, m = self.htrg(out_t, out_s, master, f"aasist.HtrgGAT_layer_ST{j}1", t_h)
            ss = self.pool(ss, f"aasist.pool_hS{j}", ordered=True)
            tt = self.pool(tt, f"aasist.pool_hT{j}", ordered=True)
            t_aug, s_aug, m_aug = self.htrg(tt, ss, m, f"aasist.HtrgGAT_layer_ST{j}2", t_h)
            branches.append((tt + t_aug, ss + s_aug, m + m_aug))
        (t1, s1, m1), (t2, s2, m2) = branches
        tt, ss, m = torch.maximum(t1, t2), torch.maximum(s1, s2), torch.maximum(m1, m2)
        hidden = torch.cat([tt.abs().amax(1), tt.mean(1), ss.abs().amax(1), ss.mean(1), m[:, 0]], dim=1)
        return linear(hidden, w, "aasist.out_layer")


POOLS = ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2", "pool_hT2")


def _swap_near_ties(idx: torch.Tensor, gap: torch.Tensor, ranks: range, margin: float) -> torch.Tensor:
    """The ranked node indices with each near-tied pair (rank r and r + 1
    for r in ``ranks``, ``gap`` below ``margin``) swapped, from the top
    down; a node swapped once stays where it went."""
    idx = idx.clone()
    done = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
    for r in ranks:
        swap = (gap[:, r] < margin) & ~done
        a, b = idx[:, r].clone(), idx[:, r + 1].clone()
        idx[:, r], idx[:, r + 1] = torch.where(swap, b, a), torch.where(swap, a, b)
        done = swap
    return idx


def logits(wav: torch.Tensor, weights: dict, cfg: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(B, n)`` -> (``(B, 2)`` logits; ``(B,)`` the smallest deciding gap
    between pool scores over the six pools; ``(B,)`` how far the bona fide
    logit moves, summed over the pools, when each pool's near ties (gaps
    below ``cfg["compare"]["min_topk_gap"]``) are broken the other way)."""
    feats = xlsr(wav, weights, cfg)
    back = _Pass(weights, cfg)
    out = back(feats)
    near = torch.stack(back.gaps, dim=1) < cfg["compare"]["min_topk_gap"]  # (B, pools)
    jump = torch.zeros_like(out[:, 1])
    for p, pool in enumerate(POOLS):
        if bool(near[:, p].any()):
            jump = jump + (_Pass(weights, cfg, swap_at=pool)(feats)[:, 1] - out[:, 1]).abs()
    return out, torch.stack(back.gaps, dim=1).amin(1), jump


def calibrate(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """One calibrating pass over ``wav`` (module docstring); the weights
    are updated in place. Returns the ``(B, 2)`` logits it computed, which
    the plain pass gives again on ``wav``."""
    return _Pass(weights, cfg, calibrate=True)(xlsr(wav, weights, cfg))


def evaluate(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
             rows: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` waveforms -> (``(B,)`` bona fide logits in ``dtype``,
    ``(B,)`` which utterances a score is compared for), in blocks of
    ``rows`` utterances.

    Two pool scores decide the answer: the k-th and (k+1)-th (which nodes
    are kept) at the two first pools, and every neighbouring pair of the
    k + 1 highest at the four pools of the branches, whose kept nodes the
    elementwise max pairs by rank. Where two such scores lie within
    ``cfg["compare"]["min_topk_gap"]`` (above the program's float32 error
    of a pool score), the last bit of the input may break the tie either
    way. An utterance is left out where breaking its near ties the other
    way moves the answer by more than ``cfg["compare"]["max_tie_jump"]``
    (half the score limit): elsewhere either way lies within the limit."""

    def block(x):
        out, _, jump = logits(x.to(dtype), weights, cfg)
        return torch.stack([out[:, 1], (jump <= cfg["compare"]["max_tie_jump"]).to(out.dtype)], dim=-1)

    out = in_blocks(block, wav, rows)
    return out[:, 0], out[:, 1] > 0


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 32) -> torch.Tensor:
    """``(B, n)`` waveforms -> ``(B,)`` bona fide logits in ``dtype``."""
    return evaluate(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)[0]
