"""Loss and metric layers in plain PyTorch.

Each reproduces the Caffe layer's scalar semantics, normalization
divisors included, as the JAX package's ops/losses.py does:
  SoftmaxWithLoss  softmax_loss_layer.cpp:51-82 (FLT_MIN clamp, /count or /outer)
  EuclideanLoss    euclidean_loss_layer.cpp (sum sq diff / 2N)
  HingeLoss        hinge_loss_layer.cpp (L1 / squared-L2 margin sum / N)
  SigmoidCrossEntropyLoss  sigmoid_cross_entropy_loss_layer.cpp (/N, stable form)
  MultinomialLogisticLoss  multinomial_logistic_loss_layer.cpp (1e-20 clamp)
  InfogainLoss     infogain_loss_layer.cpp (H matrix from file or bottom[2])
  ContrastiveLoss  contrastive_loss_layer.cpp (legacy_version switch)
  Accuracy         accuracy_layer.cpp (top-k membership, ignore_label)

Every loss is an f32 scalar; gradients come from autograd.
"""

import math

import numpy as np
import torch

from ..graph.registry import Layer, register

FLT_MIN = float(np.float32(1.1754944e-38))
LOG_THRESHOLD = 1e-20


def _outer_inner(shape, axis):
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    return outer, inner


def _rows(x, axis):
    """(outer * inner, C): the class axis moved last, rows in (outer,
    inner) order — the order of the label's elements."""
    return torch.movedim(x, axis, -1).reshape(-1, x.shape[axis])


class _Loss(Layer):
    loss_like = True

    def out_shapes(self):
        return [()]


@register
class SoftmaxWithLoss(_Loss):
    type_name = "SoftmaxWithLoss"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        self.axis = self.canonical_axis(lp.softmax_param.axis)
        loss_param = lp.loss_param
        self.normalize = bool(loss_param.normalize)
        self.ignore_label = loss_param.ignore_label \
            if loss_param.has("ignore_label") else None

    def apply(self, params, bottoms, train):
        x, label = bottoms[0], bottoms[1]
        outer, inner = _outer_inner(x.shape, self.axis)
        lab = label.reshape(-1).long()
        logp = torch.log_softmax(_rows(x, self.axis).float(), dim=-1)
        valid = None
        if self.ignore_label is not None:
            valid = lab != self.ignore_label
            lab = torch.where(valid, lab, torch.zeros_like(lab))
        # Caffe clamps prob at FLT_MIN -> logp at log(FLT_MIN)
        picked = torch.clamp(logp.gather(1, lab[:, None])[:, 0],
                             min=math.log(FLT_MIN))
        if valid is not None:
            picked = torch.where(valid, picked, torch.zeros_like(picked))
            count = torch.clamp(valid.sum(), min=1).float()
        else:
            count = outer * inner
        total = -picked.sum()
        return [total / (count if self.normalize else outer)]


@register
class EuclideanLoss(_Loss):
    type_name = "EuclideanLoss"

    def apply(self, params, bottoms, train):
        a, b = bottoms[0], bottoms[1]
        d = (a - b).float()
        return [(d * d).sum() / (2.0 * a.shape[0])]


@register
class HingeLoss(_Loss):
    type_name = "HingeLoss"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        self.norm = int(lp.hinge_loss_param.norm)  # 1=L1, 2=L2

    def apply(self, params, bottoms, train):
        x, label = bottoms[0], bottoms[1]
        n = x.shape[0]
        flat = x.reshape(n, -1).float()
        lab = label.reshape(n).long()
        sign = torch.ones_like(flat)
        sign[torch.arange(n, device=x.device), lab] = -1.0
        margins = torch.clamp(1.0 + sign * flat, min=0.0)
        if self.norm == 2:
            return [(margins * margins).sum() / n]
        return [margins.sum() / n]


@register
class SigmoidCrossEntropyLoss(_Loss):
    type_name = "SigmoidCrossEntropyLoss"

    def apply(self, params, bottoms, train):
        x, t = bottoms[0].float(), bottoms[1].float()
        # stable: loss = -[x*(t - (x>=0)) - log(1 + exp(x - 2x*(x>=0)))]
        pos = (x >= 0).float()
        loss = x * (t - pos) - torch.log1p(torch.exp(x - 2 * x * pos))
        return [-loss.sum() / x.shape[0]]


@register
class MultinomialLogisticLoss(_Loss):
    type_name = "MultinomialLogisticLoss"

    def apply(self, params, bottoms, train):
        prob, label = bottoms[0], bottoms[1]
        n = prob.shape[0]
        flat = prob.reshape(n, -1).float()
        p = flat.gather(1, label.reshape(n).long()[:, None])[:, 0]
        return [-torch.log(torch.clamp(p, min=LOG_THRESHOLD)).sum() / n]


@register
class InfogainLoss(_Loss):
    type_name = "InfogainLoss"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        self.H = None
        src = lp.infogain_loss_param.source \
            if lp.has("infogain_loss_param") else None
        if len(bottom_shapes) < 3:
            if not src:
                raise ValueError(
                    "InfogainLoss needs a source file or 3rd bottom")
            from ..proto import wire
            blob = wire.load(src, "BlobProto")
            dims = list(blob.shape.dim) if blob.has("shape") else \
                [blob.num, blob.channels, blob.height, blob.width]
            h = np.asarray(list(blob.data), np.float32).reshape(
                [d for d in dims if d] or [-1])
            self.H = h.reshape(h.shape[-2], h.shape[-1]) if h.ndim > 2 else h

    def apply(self, params, bottoms, train):
        prob, label = bottoms[0], bottoms[1]
        H = torch.as_tensor(self.H, device=prob.device) \
            if self.H is not None else bottoms[2]
        H = H.reshape(H.shape[-2], H.shape[-1]) if H.dim() > 2 else H
        n = prob.shape[0]
        logp = torch.log(torch.clamp(prob.reshape(n, -1).float(),
                                     min=LOG_THRESHOLD))
        rows = H.float()[label.reshape(n).long()]
        return [-(rows * logp).sum() / n]


@register
class ContrastiveLoss(_Loss):
    type_name = "ContrastiveLoss"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.contrastive_loss_param
        self.margin = float(p.margin)
        self.legacy = bool(p.legacy_version)

    def apply(self, params, bottoms, train):
        a, b, y = bottoms[0], bottoms[1], bottoms[2]
        n = a.shape[0]
        d = (a - b).float().reshape(n, -1)
        dist_sq = (d * d).sum(dim=1)
        y = y.reshape(n).float()
        if self.legacy:
            dissim = torch.clamp(self.margin - dist_sq, min=0.0)
        else:
            dissim = torch.clamp(self.margin - torch.sqrt(dist_sq),
                                 min=0.0) ** 2
        return [(y * dist_sq + (1.0 - y) * dissim).sum() / (2.0 * n)]


@register
class Accuracy(Layer):
    """Top-k accuracy metric (not part of the objective: loss_weight 0)."""

    type_name = "Accuracy"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        ap = lp.accuracy_param
        self.top_k = int(ap.top_k)
        self.axis = self.canonical_axis(ap.axis)
        self.ignore_label = ap.ignore_label if ap.has("ignore_label") \
            else None

    def out_shapes(self):
        return [()]

    def apply(self, params, bottoms, train):
        x, label = bottoms[0], bottoms[1]
        lab = label.reshape(-1).long()
        topk = torch.topk(_rows(x, self.axis), self.top_k, dim=1).indices
        hit = (topk == lab[:, None]).any(dim=1)
        if self.ignore_label is not None:
            valid = lab != self.ignore_label
            correct = (hit & valid).sum()
            count = torch.clamp(valid.sum(), min=1)
        else:
            correct = hit.sum()
            count = lab.numel()
        return [correct.float() / count]
