"""Plain float32 reference of the learner update (double-DQN, the SMG
reference's trainer.py backprop, batched over scenes).

Each experience's scene image and its executed-mask image go through the
trunk of its style in train mode, every BatchNorm normalizing each image
by its own mean and (biased) variance over its pixels, as the SMG
reference's batch-of-one passes do; the head reads the two feature maps
side by side, also with per-image statistics. The loss is the smooth-L1
(Huber, threshold 1) of the value against the label, summed over the
experiences and divided by their count; Adam (no weight decay) takes one
step on every parameter, a zero gradient for those no experience used.

Each experience also moves the running mean and (biased) variance of
every BatchNorm its passes went through, as the reference's batch-of-one
passes do: `new = (1 - momentum) * old + momentum * stat`, the scene
image's statistics first and the mask image's on top of them in a trunk,
the pair's once in the head. A BatchNorm that an experience did not use
keeps its old value for that experience, and the batch's new value is the
mean over its experiences.

Plain torch, float32, TF32 off, autograd for the gradients. `rnd`, when
given, rounds every conv's input, kernel and output in the forward pass,
its gradient passing through unchanged. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from smgbench.reference import densenet as dn
from smgbench.reference.scores import TRUNK, head_of


def _bn(w, name, x, eps, moments=None):
    """Per-image BatchNorm; appends (name, mean, var), each (N, C) and
    detached, to `moments` when given."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    if moments is not None:
        moments.append((name, mean.detach()[:, :, 0, 0], var.detach()[:, :, 0, 0]))
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * w[f"{name}.weight"][None, :, None, None] + w[f"{name}.bias"][None, :, None, None]


def _conv(x, k, rnd, **kw):
    if rnd is None:
        return F.conv2d(x, k, **kw)
    through = lambda t: t + (rnd(t) - t).detach()  # noqa: E731
    return through(F.conv2d(through(x), through(k), **kw))


def trunk(w, t, x, arch, rnd=None, moments=None):
    eps, g = arch["bn_eps"], arch["growth_rate"]
    bn = lambda name, y: _bn(w, name, y, eps, moments)  # noqa: E731
    h = _conv(x, w[f"{t}.conv0.weight"], rnd, stride=2, padding=arch["stem_kernel"] // 2)
    h = F.max_pool2d(torch.relu(bn(f"{t}.norm0", h)), 3, stride=2, padding=1)
    blocks = arch["block_config"]
    for i, L in enumerate(blocks):
        feats = [h]
        for l in range(L):
            p = f"{t}.denseblock{i + 1}.denselayer{l + 1}"
            y = torch.relu(bn(f"{p}.norm1", torch.cat(feats, 1)))
            y = torch.relu(bn(f"{p}.norm2", _conv(y, w[f"{p}.conv1.weight"], rnd)))
            feats.append(_conv(y, w[f"{p}.conv2.weight"], rnd, padding=1))
        h = torch.cat(feats, 1)
        if i < len(blocks) - 1:
            p = f"{t}.transition{i + 1}"
            y = torch.relu(bn(f"{p}.norm", h))
            h = F.avg_pool2d(_conv(y, w[f"{p}.conv.weight"], rnd), 2)
    return bn(f"{t}.norm5", h)


def values(w, config, style, scene_depth, exec_mask, rnd=None, running=None):
    """Train-mode values (n,) of n experiences of one style. With `running`
    ({BatchNorm name: (mean, var)}, the values before the step), returns
    also {BatchNorm name: (mean (n, C), var (n, C))}: each experience's
    running statistics after its passes."""
    arch, model = config["architecture"], config["model"]
    S = model["input_size"]
    n = scene_depth.shape[0]
    x = dn.prepare(torch.cat([scene_depth, scene_depth * exec_mask]), S)
    trunk_moments, head_moments = [], []
    f = trunk(w, TRUNK[style], x, arch, rnd, trunk_moments)
    h = head_of(style, model["tied_ets_head"])
    eps = arch["bn_eps"]
    y = torch.relu(_bn(w, f"{h}.norm0", torch.cat([f[:n], f[n:]], 1), eps, head_moments))
    y = torch.relu(_bn(w, f"{h}.norm1", _conv(y, w[f"{h}.conv0.weight"], rnd), eps,
                       head_moments))
    q = _conv(y, w[f"{h}.conv1.weight"], rnd).flatten(1)[:, 0]
    if running is None:
        return q
    mom = arch["bn_momentum"]
    ema = lambda old, stat: (1 - mom) * old + mom * stat  # noqa: E731
    new = {}
    for name, m, v in trunk_moments:       # the scene image, then the mask image
        old_m, old_v = running[name]
        new[name] = (ema(ema(old_m, m[:n]), m[n:]), ema(ema(old_v, v[:n]), v[n:]))
    for name, m, v in head_moments:
        old_m, old_v = running[name]
        new[name] = (ema(old_m, m), ema(old_v, v))
    return q, new


def huber(q, label):
    d = (q - label).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


class Update:
    """The update's parameters (float32 leaves named as the weights) and
    Adam's state; `step` takes one batch."""

    def __init__(self, weights: dict, config: dict, rnd=None):
        self.config, self.rnd = config, rnd
        train = config["train"]
        self.lr, self.b1, self.b2, self.eps = (train["learning_rate"], train["adam_b1"],
                                               train["adam_b2"], train["adam_eps"])
        self.names = [k for k, v in weights.items()
                      if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]
        self.bns = [k[:-len(".running_mean")] for k in weights if k.endswith(".running_mean")]
        self.running = {b: (weights[f"{b}.running_mean"].detach().clone(),
                            weights[f"{b}.running_var"].detach().clone()) for b in self.bns}
        self.w = dict(weights)
        for k in self.names:
            self.w[k] = weights[k].detach().clone().requires_grad_(True)
        self.m = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.v = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.t = 0

    def step(self, scene_depth, exec_mask, style, labels):
        """One Adam step; (loss, {name: gradient})."""
        if self.config["model"]["method"] != "reinforcement":
            raise NotImplementedError("the reference update is the double-DQN one")
        total = scene_depth.new_zeros(())
        B = int(style.shape[0])
        per_exp = {}     # BatchNorm name -> [(experience indices, (mean, var))]
        with dn.full_f32():
            for s in (0, 1, 2):
                idx = torch.nonzero(style == s)[:, 0]
                if idx.numel():
                    q, new = values(self.w, self.config, s, scene_depth[idx], exec_mask[idx],
                                    self.rnd, self.running)
                    total = total + huber(q, labels[idx]).sum()
                    for b, mv in new.items():
                        per_exp.setdefault(b, []).append((idx, mv))
            loss = total / max(int(style.shape[0]), 1)
            grads = torch.autograd.grad(loss, [self.w[k] for k in self.names],
                                        allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(self.w[k]))
                 for k, g in zip(self.names, grads)}
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k in self.names:
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (self.v[k] / c2).sqrt() + self.eps
                self.w[k] -= self.lr * (self.m[k] / c1) / denom
            for b, parts in per_exp.items():
                stats = []
                for j, old in enumerate(self.running[b]):
                    each = old.expand(B, -1).clone()
                    for idx, mv in parts:
                        each[idx] = mv[j]
                    stats.append(each.mean(dim=0))
                self.running[b] = tuple(stats)
        return float(loss.detach()), grads

    def change(self, weights: dict) -> dict:
        """{name: norm of the parameter's change from `weights`}."""
        return {k: float((self.w[k].detach() - weights[k]).norm()) for k in self.names}

    def stats_change(self, weights: dict) -> dict:
        """{buffer name: norm of the running statistic's change from `weights`}."""
        out = {}
        for b, (mean, var) in self.running.items():
            for key, t in (("running_mean", mean), ("running_var", var)):
                out[f"{b}.{key}"] = float((t - weights[f"{b}.{key}"]).norm())
        return out


def norms(tensors: dict) -> dict:
    return {k: float(v.norm()) for k, v in tensors.items()}


def median(xs) -> float:
    """The median of the nonzero values (leaves no experience used are 0)."""
    s = sorted(x for x in xs if x > 0)
    return s[len(s) // 2] if s else math.nan
