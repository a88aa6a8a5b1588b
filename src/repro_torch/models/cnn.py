"""MobileNetV2-style inverted-residual CNN — the paper's own architecture
(Sandler et al. 2018) with BatchNorm + ReLU6, so the full paper pipeline
applies exactly: BN fold → ReLU6→ReLU swap → CLE → bias absorption (BN
statistics) → analytic bias correction (clipped normal). Port of
``repro.models.cnn``.

The parameter trees keep the JAX package's layout — HWIO kernels,
depthwise kernels ``[3, 3, 1, C]``, NHWC activations, lists of blocks,
``FoldedLayer`` leaves — so every transform compares with the JAX one leaf
for leaf. Only the convolution itself views its operands as NCHW / OIHW
for ``F.conv2d`` (an NHWC tensor viewed as NCHW is channels-last memory,
so nothing is copied). Every transform returns a new tree and never writes
into its input.

On the card the convolutions and the head run in float32: cuDNN's default
TF32 would round every product's inputs to 10 mantissa bits (``fp32``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core import (
    BNParams,
    ConvLayer,
    QuantSpec,
    absorb_conv,
    absorption_amount,
    bias_correction_conv,
    equalize_conv_chain,
    expected_input_analytic,
    fake_quant,
    fold_bn_conv,
)
from ..data import prng
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "mobilenet_v2"
    in_channels: int = 3
    num_classes: int = 10
    width: int = 16
    # (expansion, out_channels, stride) per inverted-residual block
    blocks: tuple = ((1, 16, 1), (4, 24, 2), (4, 24, 1), (4, 32, 2), (4, 32, 1))
    img_size: int = 32
    act_clip: Optional[float] = 6.0  # ReLU6 (paper swaps to ReLU pre-CLE)


@contextlib.contextmanager
def fp32(allow_tf32: bool = False):
    """Convolutions and matrix products in float32 within the block (or in
    TF32 with ``allow_tf32=True``); the previous settings come back after
    it. Put a training step's backward inside it too."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _same_pad(n: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial axis: the total the windows need,
    the smaller half before (at n=32, k=3, stride 2: (0, 1))."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"), feature_group_count=groups)``. Where XLA pads
    one side more than the other (stride 2), the padding is explicit:
    ``F.conv2d(padding=1)`` would pad both sides and shift every window."""
    (top, bottom) = _same_pad(x.shape[1], w.shape[0], stride)
    (left, right) = _same_pad(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        padding = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        padding = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _act(x: torch.Tensor, clip_max: Optional[float]) -> torch.Tensor:
    x = torch.relu(x)
    return torch.clamp_max(x, clip_max) if clip_max is not None else x


def _copy(tree):
    """A new tree of the same dicts and lists holding the same leaves (no
    transform writes into a tensor, so the leaves may be shared)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


ActQuant = Callable[[torch.Tensor, str, torch.Tensor, torch.Tensor],
                    torch.Tensor]


class MobileNetCNN:
    """Params: stem conv+bn, blocks of (expand 1x1, depthwise 3x3, project
    1x1) each with BN, then GAP + dense classifier."""

    def __init__(self, cfg: CNNConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = "cuda") -> dict:
        """The JAX package's ``init(PRNGKey(seed))``: its keys and normal
        draws (``prng``, within 4 ulp), each divided by √fan in float32 on
        the host, then moved to ``device`` — the same tree on the card and
        the CPU."""
        cfg = self.cfg
        dev = resolve_device(device)
        ks = iter(prng.split(prng.PRNGKey(seed), 4 + 3 * len(cfg.blocks)))

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        def conv_init(k, kh, kw, cin, cout):
            fan = kh * kw * cin
            return t(prng.normal(k, (kh, kw, cin, cout))
                     / np.float32(fan ** 0.5))

        def bn_init(c):
            return {"gamma": t(np.ones(c)), "beta": t(np.zeros(c)),
                    "mean": t(np.zeros(c)), "var": t(np.ones(c))}

        params: dict = {
            "stem": {"w": conv_init(next(ks), 3, 3, cfg.in_channels, cfg.width),
                     "bn": bn_init(cfg.width)},
            "blocks": [],
        }
        cin = cfg.width
        for exp, cout, _ in cfg.blocks:
            mid = cin * exp
            params["blocks"].append({
                "expand": {"w": conv_init(next(ks), 1, 1, cin, mid),
                           "bn": bn_init(mid)},
                "dw": {"w": conv_init(next(ks), 3, 3, 1, mid),
                       "bn": bn_init(mid)},
                "project": {"w": conv_init(next(ks), 1, 1, mid, cout),
                            "bn": bn_init(cout)},
            })
            cin = cout
        params["head"] = {
            "w": t(prng.normal(next(ks), (cin, cfg.num_classes))
                   / np.float32(cin ** 0.5)),
            "b": t(np.zeros(cfg.num_classes)),
        }
        return params

    # ---------------------------------------------------------- training fwd
    def apply_train(self, params: dict, x: torch.Tensor,
                    train_bn: bool = True):
        """Forward with live batch statistics; returns logits and a new
        tree with the running BN statistics updated (0.9 · old + 0.1 ·
        batch, the batch variance the population variance — not
        ``nn.BatchNorm2d``'s unbiased one or its momentum)."""
        cfg = self.cfg
        new_params = _copy(params)

        def bn_apply(h, bn, path):
            if train_bn:
                mu = h.mean(dim=(0, 1, 2))
                var = h.var(dim=(0, 1, 2), unbiased=False)
                node = new_params
                for k in path[:-1]:
                    node = node[k]
                with torch.no_grad():      # statistics, not a loss term
                    node[path[-1]] = {
                        "gamma": bn["gamma"], "beta": bn["beta"],
                        "mean": 0.9 * bn["mean"] + 0.1 * mu,
                        "var": 0.9 * bn["var"] + 0.1 * var,
                    }
            else:
                mu, var = bn["mean"], bn["var"]
            return (h - mu) * torch.rsqrt(var + 1e-5) * bn["gamma"] + bn["beta"]

        with fp32():
            h = _conv(x, params["stem"]["w"], 2)
            h = _act(bn_apply(h, params["stem"]["bn"], ("stem", "bn")),
                     cfg.act_clip)
            for i, blk in enumerate(params["blocks"]):
                inp = h
                h = _conv(h, blk["expand"]["w"])
                h = _act(bn_apply(h, blk["expand"]["bn"],
                                  ("blocks", i, "expand", "bn")), cfg.act_clip)
                h = _conv(h, blk["dw"]["w"], cfg.blocks[i][2],
                          groups=blk["dw"]["w"].shape[-1])
                h = _act(bn_apply(h, blk["dw"]["bn"],
                                  ("blocks", i, "dw", "bn")), cfg.act_clip)
                h = _conv(h, blk["project"]["w"])
                h = bn_apply(h, blk["project"]["bn"],
                             ("blocks", i, "project", "bn"))
                if inp.shape == h.shape:
                    h = h + inp
            h = h.mean(dim=(1, 2))
            logits = h @ params["head"]["w"] + params["head"]["b"]
        return logits, new_params

    def loss(self, params: dict, batch: dict):
        """Mean cross-entropy of ``apply_train``'s logits, and its new
        tree. The loss does not read the running statistics: their
        gradients are zero (autograd leaves them unset)."""
        logits, new_params = self.apply_train(params, batch["x"])
        logz = torch.logsumexp(logits, -1)
        gold = torch.take_along_dim(logits, batch["y"][:, None], -1)[:, 0]
        return torch.mean(logz - gold), new_params

    # ------------------------------------------------- folded inference form
    def fold(self, params: dict) -> dict:
        """BN-fold every conv (paper §5). Returns the inference tree of
        ``FoldedLayer`` entries, with each layer's BN moments for BA/BC."""
        def fold_one(w, bn):
            return fold_bn_conv(w, None, BNParams(
                bn["gamma"], bn["beta"], bn["mean"], bn["var"]))

        folded: dict = {"stem": fold_one(params["stem"]["w"],
                                         params["stem"]["bn"]),
                        "blocks": []}
        for i, blk in enumerate(params["blocks"]):
            folded["blocks"].append({
                "expand": fold_one(blk["expand"]["w"], blk["expand"]["bn"]),
                "dw": fold_one(blk["dw"]["w"], blk["dw"]["bn"]),
                "stride": self.cfg.blocks[i][2],
                "project": fold_one(blk["project"]["w"], blk["project"]["bn"]),
            })
        folded["head"] = dict(params["head"])
        return folded

    def apply_folded(self, folded: dict, x: torch.Tensor,
                     act_clip: Optional[float] = None,
                     act_quant: Optional[ActQuant] = None,
                     allow_tf32: bool = False) -> torch.Tensor:
        """Inference on the folded form. ``act_quant(h, layer_name, mean,
        std)`` optionally fake-quantizes activations (data-free ranges
        β ± 6γ). ``allow_tf32`` lets the card round the products' inputs
        to TF32 (the error that costs is measured, not served)."""
        def act(h, name, mean, std):
            h = _act(h, act_clip)
            if act_quant is not None:
                h = act_quant(h, name, mean, std)
            return h

        with fp32(allow_tf32):
            h = _conv(x, folded["stem"].w, 2) + folded["stem"].b
            h = act(h, "stem", folded["stem"].act_mean,
                    folded["stem"].act_std)
            for i, blk in enumerate(folded["blocks"]):
                inp = h
                h = _conv(h, blk["expand"].w) + blk["expand"].b
                h = act(h, f"b{i}_expand", blk["expand"].act_mean,
                        blk["expand"].act_std)
                h = _conv(h, blk["dw"].w, blk["stride"],
                          groups=blk["dw"].w.shape[-1])
                h = act(h, f"b{i}_dw", blk["dw"].act_mean, blk["dw"].act_std)
                h = _conv(h, blk["project"].w) + blk["project"].b
                if inp.shape == h.shape:
                    h = h + inp
            h = h.mean(dim=(1, 2))
            return h @ folded["head"]["w"] + folded["head"]["b"]

    # -------------------------------------------------------------- DFQ flow
    def chains(self, folded: dict) -> List[List[tuple]]:
        """Equalization chains (paths into the folded tree), one per
        inverted-residual block: expand → depthwise → project (paper
        §5.1.1: equalization within each residual block)."""
        return [[(("blocks", i, "expand"), "conv"),
                 (("blocks", i, "dw"), "depthwise"),
                 (("blocks", i, "project"), "conv")]
                for i in range(len(folded["blocks"]))]

    def equalize(self, folded: dict, iterations: int = 20) -> dict:
        folded = _copy(folded)
        for chain in self.chains(folded):
            nodes = []
            for path, _ in chain:
                node = folded
                for k in path[:-1]:
                    node = node[k]
                nodes.append((node, path[-1]))
            layers = [ConvLayer(node[key].w, node[key].b, kind)
                      for (node, key), (_, kind) in zip(nodes, chain)]
            new_layers, cum, _ = equalize_conv_chain(layers, iterations)
            for j, (node, key) in enumerate(nodes):
                fl = node[key]
                if j < len(cum):
                    # layer j's output channels were divided by cum[j]: the
                    # BN-derived pre-activation moments scale identically
                    # (exact: the whole channel, weights+bias, is rescaled)
                    mean, std = fl.act_mean / cum[j], fl.act_std / cum[j]
                else:
                    mean, std = fl.act_mean, fl.act_std
                node[key] = fl._replace(w=new_layers[j].w, b=new_layers[j].b,
                                        act_mean=mean, act_std=std)
        return folded

    def absorb_high_bias(self, folded: dict, n_sigma: float = 3.0) -> dict:
        """Paper §4.1.3 over each (expand→dw) and (dw→project) interface."""
        folded = _copy(folded)
        for blk in folded["blocks"]:
            for src, dst, depthwise in (("expand", "dw", True),
                                        ("dw", "project", False)):
                fl1, fl2 = blk[src], blk[dst]
                c = absorption_amount(fl1.act_mean, fl1.act_std, n_sigma)
                res = absorb_conv(fl1.b, fl2.w, fl2.b, c, depthwise=depthwise)
                blk[src] = fl1._replace(b=res.b1, act_mean=fl1.act_mean - c)
                blk[dst] = fl2._replace(b=res.b2)
        return folded

    def quantize_weights(self, folded: dict, spec: QuantSpec) -> dict:
        q = _copy(folded)
        q["stem"] = q["stem"]._replace(w=fake_quant(q["stem"].w, spec))
        for blk in q["blocks"]:
            for k in ("expand", "dw", "project"):
                blk[k] = blk[k]._replace(w=fake_quant(blk[k].w, spec))
        q["head"]["w"] = fake_quant(q["head"]["w"], spec)
        return q

    def bias_correct_analytic(self, folded: dict, q: dict, spec: QuantSpec,
                              act_clip: Optional[float] = None) -> dict:
        """Paper §4.2.1: E[x] from the clipped-normal closed form on the
        previous layer's BN moments; a correction per conv (appendix B).
        As the JAX package does, block i > 0 takes E[x] as the previous
        project's β and ignores the residual add."""
        q = _copy(q)
        act = "relu6" if act_clip == 6.0 else "relu"
        for i, blk in enumerate(folded["blocks"]):
            prev = folded["stem"] if i == 0 else folded["blocks"][i - 1]["project"]
            # project has no activation after it (linear bottleneck)
            e_in = (expected_input_analytic(prev.act_mean, prev.act_std, act)
                    if i == 0 else prev.act_mean)
            qblk = q["blocks"][i]
            qblk["expand"] = qblk["expand"]._replace(b=bias_correction_conv(
                blk["expand"].w, qblk["expand"].b, e_in, spec))
            e_mid = expected_input_analytic(blk["expand"].act_mean,
                                            blk["expand"].act_std, act)
            qblk["dw"] = qblk["dw"]._replace(b=bias_correction_conv(
                blk["dw"].w, qblk["dw"].b, e_mid, spec, depthwise=True))
            e_dw = expected_input_analytic(blk["dw"].act_mean,
                                           blk["dw"].act_std, act)
            qblk["project"] = qblk["project"]._replace(b=bias_correction_conv(
                blk["project"].w, qblk["project"].b, e_dw, spec))
        return q
