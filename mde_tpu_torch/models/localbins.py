"""LocalBins metric-depth head, ZoeDepth-style attractor bins (port of
mde_tpu/models/localbins.py).

A seed bin regressor on the bottleneck feature, a chain of attractor layers
refining the bin centers down the decoder pyramid, and a conditional
log-binomial distribution over the bins; depth = sum(p_k * c_k). NCHW: the
bins are channel axis 1, and the attractor delta is a (B, nA, n_bins, H, W)
broadcast summed over axis 1 (the attractors). Every resize is bilinear with
align_corners=True.

Named as the reference's layers (src/network/localbins_layers.py): MLPs are
``_net`` (``mlp`` for the conditional log-binomial) Sequentials with the convs
at 0 and 2, so ``LocalBinsBlock.state_dict()`` is the reference's
``local_bins.*`` surface, with LogBinomial's ``k_idx``/``K_minus_1``
buffers (constants, rebuilt here; mde_tpu does not load them).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Conv
from ..ops.resize import resize_bilinear


def exp_attractor(dx, alpha: float = 300.0, gamma: int = 2):
    """dc = exp(-alpha * |dx|^gamma) * dx (localbins_layers.py:171-183)."""
    return torch.exp(-alpha * dx.abs() ** gamma) * dx


def inv_attractor(dx, alpha: float = 300.0, gamma: int = 2):
    """dc = dx / (1 + alpha * dx^gamma) (localbins_layers.py:186-199)."""
    return dx / (1.0 + alpha * dx ** gamma)


def _mlp(cin: int, hidden: int, cout: int, act: nn.Module, out_act=None) -> nn.Sequential:
    """Conv1x1, ``act``, Conv1x1 (and ``out_act``): the reference's ``_net``."""
    layers = [Conv(cin, hidden, 1), act, Conv(hidden, cout, 1)]
    return nn.Sequential(*layers, *([out_act] if out_act is not None else []))


class SeedBinRegressorUnnormed(nn.Module):
    """1x1 MLP -> softplus bin centers, unbounded (localbins_layers.py:71-96)."""

    def __init__(self, cin: int, n_bins: int = 16, mlp_dim: int = 256):
        super().__init__()
        self._net = _mlp(cin, mlp_dim, n_bins, nn.ReLU(), nn.Softplus())

    def forward(self, x):
        centers = self._net(x)
        return centers, centers


class SeedBinRegressor(nn.Module):
    """The normed variant: widths -> cumsum edges -> centers inside
    (min_depth, max_depth) (localbins_layers.py:29-68)."""

    def __init__(self, cin: int, n_bins: int = 16, mlp_dim: int = 256,
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp(cin, mlp_dim, n_bins, nn.ReLU(), nn.ReLU())

    def forward(self, x):
        b = self._net(x) + 1e-3
        widths_normed = b / b.sum(dim=1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * widths_normed
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        return widths_normed, 0.5 * (edges[:, :-1] + edges[:, 1:])


class Projector(nn.Module):
    """1x1 MLP feature -> bin embedding (localbins_layers.py:99-117)."""

    def __init__(self, cin: int, cout: int, mlp_dim: int = 128):
        super().__init__()
        self._net = _mlp(cin, mlp_dim, cout, nn.ReLU())

    def forward(self, x):
        return self._net(x)


def _add_embedding(x, prev_b_embedding):
    if prev_b_embedding is None:
        return x
    return x + resize_bilinear(prev_b_embedding, x.shape[-2:], align_corners=True)


class AttractorLayerUnnormed(nn.Module):
    """Bin-center refinement by attractor points (localbins_layers.py:201-270)."""

    def __init__(self, cin: int, n_bins: int = 16, n_attractors: int = 16, mlp_dim: int = 128,
                 alpha: float = 300.0, gamma: int = 2, kind: str = "sum",
                 attractor_type: str = "exp"):
        super().__init__()
        self.n_attractors, self.alpha, self.gamma = n_attractors, alpha, gamma
        self.kind, self.attractor_type = kind, attractor_type
        self._net = _mlp(cin, mlp_dim, n_attractors, nn.ReLU(), nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding=None):
        x = _add_embedding(x, prev_b_embedding)
        a = self._net(x)  # (B, nA, H, W)
        b_centers = resize_bilinear(b_prev, x.shape[-2:], align_corners=True)
        dist = exp_attractor if self.attractor_type == "exp" else inv_attractor
        dx = a[:, :, None] - b_centers[:, None]  # (B, nA, n_bins, H, W)
        delta = dist(dx, self.alpha, self.gamma).sum(dim=1)
        if self.kind == "mean":
            delta = delta / self.n_attractors
        b_new = b_centers + delta
        return b_new, b_new


class LinearSplitter(nn.Module):
    """Splits each bin into ``split_factor`` sub-bins (localbins_layers.py:
    121-169). The reference defines it and its live path never uses it."""

    def __init__(self, cin: int, prev_nbins: int, split_factor: int = 2, mlp_dim: int = 128,
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        super().__init__()
        self.prev_nbins, self.split_factor = prev_nbins, split_factor
        self.min_depth, self.max_depth = min_depth, max_depth
        self._net = _mlp(cin, mlp_dim, prev_nbins * split_factor, nn.GELU(), nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding=None):
        x = _add_embedding(x, prev_b_embedding)
        s = self._net(x) + 1e-3
        b_, _, hh, ww = s.shape
        s = s.reshape(b_, self.prev_nbins, self.split_factor, hh, ww)
        s_normed = s / s.sum(dim=2, keepdim=True)
        b_prev = resize_bilinear(b_prev, (hh, ww), align_corners=True)
        b_prev = b_prev / b_prev.sum(dim=1, keepdim=True)
        b = (b_prev[:, :, None] * s_normed).reshape(b_, -1, hh, ww)
        widths = F.pad((self.max_depth - self.min_depth) * b, (0, 0, 0, 0, 1, 0),
                       value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        return b, 0.5 * (edges[:, :-1] + edges[:, 1:])


def log_binom(n, k, eps: float = 1e-7):
    """log(nCk) by Stirling (localbins_layers.py:272-276), with ``n - k``
    clamped at 0 as mde_tpu does: at k == n a rounding below 0 would take the
    log of a negative number."""
    n = n + eps
    k = k + eps
    nk = torch.clamp(n - k, min=0.0)
    return n * torch.log(n) - k * torch.log(k) - nk * torch.log(nk + eps)


class LogBinomial(nn.Module):
    """A binomial distribution over the classes (channel axis 1) from a
    probability map (localbins_layers.py:278-311). ``k_idx`` (int64) and
    ``K_minus_1`` are the reference's buffers."""

    def __init__(self, n_classes: int = 256):
        super().__init__()
        self.K = n_classes
        self.register_buffer("k_idx", torch.empty(1, n_classes, 1, 1, dtype=torch.int64))
        self.register_buffer("K_minus_1", torch.empty(1, 1, 1, 1))

    def init_leaves_(self, generator):
        self.k_idx.copy_(torch.arange(self.K).view(1, -1, 1, 1))
        self.K_minus_1.fill_(self.K - 1.0)

    def forward(self, x, t=1.0, eps: float = 1e-4):
        if x.dim() == 3:
            x = x[:, None]
        k_idx = torch.arange(self.K, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
        one_minus_x = torch.clamp(1.0 - x, eps, 1.0)
        x = torch.clamp(x, eps, 1.0)
        y = (log_binom(torch.tensor(self.K - 1.0, dtype=x.dtype, device=x.device), k_idx)
             + k_idx * torch.log(x) + (self.K - 1 - k_idx) * torch.log(one_minus_x))
        return torch.softmax(y / t, dim=1)


class ConditionalLogBinomial(nn.Module):
    """p and t, each normalised over two channels, into a LogBinomial
    (localbins_layers.py:313-361)."""

    def __init__(self, cin: int, condition_dim: int, n_classes: int = 16,
                 bottleneck_factor: int = 2, p_eps: float = 1e-4, max_temp: float = 50.0,
                 min_temp: float = 1e-7):
        super().__init__()
        self.p_eps, self.max_temp, self.min_temp = p_eps, max_temp, min_temp
        self.log_binomial_transform = LogBinomial(n_classes)
        bottleneck = (cin + condition_dim) // bottleneck_factor
        self.mlp = _mlp(cin + condition_dim, bottleneck, 4, nn.GELU(), nn.Softplus())

    def forward(self, x, cond):
        pt = self.mlp(torch.cat([x, cond], dim=1))
        p, t = pt[:, :2] + self.p_eps, pt[:, 2:] + self.p_eps
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        return self.log_binomial_transform(p, t[:, None])


class LocalBinsBlock(nn.Module):
    """The LocalBins head (localbins_net.py:12-110).

    ``channels``: the bottleneck's, then each decoder level's (MiDaS-small:
    512, 256, 128, 64, 64). ``forward(out, rel_depth)`` with out =
    [outconv activation (B, 1, H, W), bottleneck, path_4, path_3, path_2,
    path_1] and rel_depth (B, H, W) -> metric depth (B, H, W).
    """

    def __init__(self, channels: Sequence[int] = (512, 256, 128, 64, 64), n_bins: int = 16,
                 max_depth: float = 10.0, min_depth: float = 1e-3, bin_embedding_dim: int = 128,
                 n_attractors: Sequence[int] = (16, 8, 4, 1), attractor_alpha: float = 300.0,
                 attractor_gamma: int = 2, attractor_kind: str = "sum",
                 attractor_type: str = "inv", min_temp: float = 5.0, max_temp: float = 50.0):
        super().__init__()
        btlnck, levels = channels[0], channels[1:]
        self.conv2 = Conv(btlnck, btlnck, 1)
        self.seed_bin_regressor = SeedBinRegressorUnnormed(btlnck, n_bins)
        self.seed_projector = Projector(btlnck, bin_embedding_dim)
        self.projectors = nn.ModuleList([Projector(c, bin_embedding_dim) for c in levels])
        self.attractors = nn.ModuleList([
            AttractorLayerUnnormed(bin_embedding_dim, n_bins, int(n_attractors[i]),
                                   alpha=attractor_alpha, gamma=attractor_gamma,
                                   kind=attractor_kind, attractor_type=attractor_type)
            for i in range(len(levels))])
        # the outconv activation and the relative depth: two channels
        self.conditional_log_binomial = ConditionalLogBinomial(
            2, bin_embedding_dim, n_bins, min_temp=min_temp, max_temp=max_temp)

    def forward(self, out, rel_depth):
        outconv_activation, btlnck, x_blocks = out[0], out[1], out[2:]
        x = self.conv2(btlnck)
        _, b_prev = self.seed_bin_regressor(x)
        prev_b_embedding = self.seed_projector(x)
        b_centers = b_prev
        for projector, attractor, xb in zip(self.projectors, self.attractors, x_blocks):
            b_embedding = projector(xb)
            b_prev, b_centers = attractor(b_embedding, b_prev, prev_b_embedding)
            prev_b_embedding = b_embedding
        size = outconv_activation.shape[-2:]
        rel_cond = resize_bilinear(rel_depth[:, None], size, align_corners=True)
        last = torch.cat([outconv_activation, rel_cond], dim=1)
        b_embedding = resize_bilinear(prev_b_embedding, size, align_corners=True)
        probs = self.conditional_log_binomial(last, b_embedding)
        b_centers = resize_bilinear(b_centers, probs.shape[-2:], align_corners=True)
        return (probs * b_centers).sum(dim=1)
