"""Face detection (S3FD), face parsing (BiSeNet on ResNet-18) and facial
landmarks (FAN, 2DFAN4): the face networks of lip sync.

Counterpart of ``rvc_tpu/models/musetalk/face.py`` (the reference's
face_detection and face_parsing packages). NCHW; the modules carry the
state_dict names of face-alignment's ``s3fd.pth`` and ``2DFAN4`` and of
face-parsing's ``79999_iter.pth`` (its ``conv_out16``/``conv_out32``
training heads are dropped on load), so each loads with
``load_state_dict``. BatchNorm runs with its loaded statistics.

Pooling differs from the JAX package's only where the JAX package raises:
its 2x2 pools reshape (face.py:38-40, :358-360), so a side that is not even
fails there; here the pool drops the last row or column, as the
reference's ``F.max_pool2d`` / ``F.avg_pool2d`` do. BiSeNet's nearest
upsampling takes the centre of each output pixel (``nearest-exact``), as
``jax.image.resize`` does.

``decode_s3fd`` and ``nms`` are the JAX package's numpy functions, taking
the port's NCHW maps; ``decode_s3fd`` computes every candidate at once and
returns them in the JAX loop's order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device, set_float32_math
from ..layers import BatchNorm, Conv2d


def conv(ci: int, co: int, k: int, s: int = 1, p: int = 0, bias: bool = True) -> Conv2d:
    return Conv2d(ci, co, (k, k), (s, s), (p, p), bias=bias)


# ---------------------------------------------------------------------------
# S3FD face detector (VGG16 + extras + multi-scale heads)
# ---------------------------------------------------------------------------


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight[None, :, None, None]


_S3FD_VGG = [("conv1_1", 3, 64), ("conv1_2", 64, 64), None,
             ("conv2_1", 64, 128), ("conv2_2", 128, 128), None,
             ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), None,
             ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), None,
             ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), None]
_S3FD_HEADS = [("conv3_3_norm", 256, 4), ("conv4_3_norm", 512, 2), ("conv5_3_norm", 512, 2),
               ("fc7", 1024, 2), ("conv6_2", 512, 2), ("conv7_2", 256, 2)]


class S3FD(nn.Module):
    """face-alignment's S3FD: (B, 3, H, W) BGR, mean-subtracted -> the 12
    maps [cls1, reg1, cls2, reg2, ...] (NCHW), strides 4 to 128. ``fc6`` is
    a 3x3 conv with padding 3 and no dilation, as the JAX module's."""

    def __init__(self):
        super().__init__()
        for layer in _S3FD_VGG:
            if layer is not None:
                name, ci, co = layer
                self.add_module(name, conv(ci, co, 3, 1, 1))
        self.fc6 = conv(512, 1024, 3, 1, 3)
        self.fc7 = conv(1024, 1024, 1)
        self.conv6_1 = conv(1024, 256, 1)
        self.conv6_2 = conv(256, 512, 3, 2, 1)
        self.conv7_1 = conv(512, 128, 1)
        self.conv7_2 = conv(128, 256, 3, 2, 1)
        self.conv3_3_norm = L2Norm(256, 10.0)
        self.conv4_3_norm = L2Norm(512, 8.0)
        self.conv5_3_norm = L2Norm(512, 5.0)
        for name, ci, ncls in _S3FD_HEADS:
            self.add_module(f"{name}_mbox_conf", conv(ci, ncls, 3, 1, 1))
            self.add_module(f"{name}_mbox_loc", conv(ci, 4, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h, feats = x, {}
        for layer in _S3FD_VGG:
            if layer is None:
                h = F.max_pool2d(h, 2, 2)
            else:
                h = F.relu(getattr(self, layer[0])(h))
                if layer[0] in ("conv3_3", "conv4_3", "conv5_3"):
                    feats[layer[0] + "_norm"] = h
        h = F.relu(self.fc7(F.relu(self.fc6(h))))
        feats["fc7"] = h
        h = F.relu(self.conv6_2(F.relu(self.conv6_1(h))))
        feats["conv6_2"] = h
        feats["conv7_2"] = F.relu(self.conv7_2(F.relu(self.conv7_1(h))))
        for name in ("conv3_3_norm", "conv4_3_norm", "conv5_3_norm"):
            feats[name] = getattr(self, name)(feats[name])
        outs = []
        for name, _, _ in _S3FD_HEADS:
            outs += [getattr(self, f"{name}_mbox_conf")(feats[name]),
                     getattr(self, f"{name}_mbox_loc")(feats[name])]
        # the first scale: background maxed out over its three labels
        c = outs[0]
        outs[0] = torch.cat([torch.maximum(torch.maximum(c[:, :1], c[:, 1:2]), c[:, 2:3]),
                             c[:, 3:]], dim=1)
        return outs


def decode_s3fd(outs, scale_threshold: float = 0.05) -> np.ndarray:
    """Anchor decode of the first image's 12 maps (NCHW arrays or
    tensors): (N, 5) [score, x1, y1, x2, y2] float32 candidates above
    ``scale_threshold``, scale by scale, row-major within a scale, as the
    JAX package's loop lists them; apply NMS downstream."""
    boxes = []
    for i in range(len(outs) // 2):
        ocls, oreg = (np.asarray(o.detach().cpu() if isinstance(o, torch.Tensor) else o)[0]
                      .transpose(1, 2, 0) for o in outs[2 * i: 2 * i + 2])
        stride = 2 ** (i + 2)
        e = np.exp(ocls - ocls.max(-1, keepdims=True))
        score = (e / e.sum(-1, keepdims=True))[..., 1]
        ys, xs = np.where(score > scale_threshold)
        if len(ys) == 0:
            continue
        s = score[ys, xs]
        axc, ayc = stride / 2 + xs * stride, stride / 2 + ys * stride
        aww = ahh = stride * 4
        loc = oreg[ys, xs]
        cx = axc + loc[:, 0] * 0.1 * aww
        cy = ayc + loc[:, 1] * 0.1 * ahh
        w = aww * np.exp(loc[:, 2] * 0.2)
        hgt = ahh * np.exp(loc[:, 3] * 0.2)
        boxes.append(np.stack([s, cx - w / 2, cy - hgt / 2, cx + w / 2, cy + hgt / 2], -1)
                     .astype(np.float32))
    if not boxes:
        return np.zeros((0, 5), np.float32)
    return np.concatenate(boxes)


def nms(dets: np.ndarray, thresh: float = 0.3) -> np.ndarray:
    """IoU NMS over (N, 5) [score, x1, y1, x2, y2] (the JAX package's)."""
    if len(dets) == 0:
        return dets
    scores, x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return dets[keep]


def first_kept(dets: np.ndarray) -> np.ndarray | None:
    """``nms(dets)[0]`` without the rest of NMS: the first box NMS keeps is
    the first of its score order, and the pipeline keeps only that one.
    The full NMS loops once a kept box over the candidates left, and
    seeded or untrained weights pass many candidates over the threshold.
    None when there is no candidate."""
    if len(dets) == 0:
        return None
    return dets[dets[:, 0].argsort()[::-1][0]]


# ---------------------------------------------------------------------------
# BiSeNet face parsing (ResNet-18 backbone)
# ---------------------------------------------------------------------------


class ConvBNReLU(nn.Module):
    def __init__(self, ci: int, co: int, k: int = 3, s: int = 1, p: int = 1):
        super().__init__()
        self.conv = conv(ci, co, k, s, p, bias=False)
        self.bn = BatchNorm(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlockR18(nn.Module):
    def __init__(self, ci: int, co: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(ci, co, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(co)
        self.conv2 = conv(co, co, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(co)
        self.downsample = (nn.Sequential(conv(ci, co, 1, stride, 0, bias=False), BatchNorm(co))
                           if stride != 1 or ci != co else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((x if self.downsample is None else self.downsample(x)) + h)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, (co, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)], start=1):
            self.add_module(f"layer{li}", nn.Sequential(BasicBlockR18(cin, co, s),
                                                        BasicBlockR18(co, co, 1)))
            cin = co

    def forward(self, x: torch.Tensor):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        feat8 = self.layer2(self.layer1(h))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)  # 1/8, 1/16, 1/32


class AttentionRefinement(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv = ConvBNReLU(ci, co, 3, 1, 1)
        self.conv_atten = conv(co, co, 1, bias=False)
        self.bn_atten = BatchNorm(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class FeatureFusion(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.convblk = ConvBNReLU(ci, co, 1, 1, 0)
        self.conv1 = conv(co, co // 4, 1, bias=False)
        self.conv2 = conv(co // 4, co, 1, bias=False)

    def forward(self, sp: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([sp, cp], dim=1))
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))))
        return feat + feat * atten


class BiSeNetOutput(nn.Module):
    def __init__(self, ci: int, mid: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(ci, mid, 3, 1, 1)
        self.conv_out = conv(mid, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0)

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg
        f32 = self.conv_head32(F.interpolate(f32, size=feat16.shape[2:], mode="nearest-exact"))
        f16 = self.arm16(feat16) + f32
        f16 = self.conv_head16(F.interpolate(f16, size=feat8.shape[2:], mode="nearest-exact"))
        return feat8, f16


class BiSeNet(nn.Module):
    """face-parsing's BiSeNet: (B, 3, H, W) ImageNet-normalized RGB ->
    (B, n_classes, H, W) logits (bilinear from 1/8, half-pixel centres)."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat8, f16 = self.cp(x)
        out = self.conv_out(self.ffm(feat8, f16))
        return F.interpolate(out, size=x.shape[2:], mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# FAN facial landmarks (stacked hourglass, 68 heatmaps)
# ---------------------------------------------------------------------------


class FANConvBlock(nn.Module):
    """Pre-activation residual block with a 1/2 + 1/4 + 1/4 channel split."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = conv(cin, cout // 2, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout // 2)
        self.conv2 = conv(cout // 2, cout // 4, 3, 1, 1, bias=False)
        self.bn3 = BatchNorm(cout // 4)
        self.conv3 = conv(cout // 4, cout // 4, 3, 1, 1, bias=False)
        self.downsample = (nn.Sequential(BatchNorm(cin), nn.ReLU(), conv(cin, cout, 1, bias=False))
                           if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], dim=1) + res


class HourGlassFAN(nn.Module):
    """The recursive hourglass, its blocks under the reference's names
    (``b1_4``, ``b2_4``, ..., ``b2_plus_1``, ``b3_1``)."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            for name in ("b1", "b2", "b3") + (("b2_plus",) if lv == 1 else ()):
                self.add_module(f"{name}_{lv}", FANConvBlock(features, features))

    def _level(self, lv: int, x: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lv}")(x)
        low1 = getattr(self, f"b2_{lv}")(F.avg_pool2d(x, 2, 2))
        low2 = self._level(lv - 1, low1) if lv > 1 else getattr(self, f"b2_plus_{lv}")(low1)
        low3 = getattr(self, f"b3_{lv}")(low2)
        return up1 + F.interpolate(low3, scale_factor=2.0, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    """2DFAN: (B, 3, H, W) RGB in [0, 1] -> the last module's 68 heatmaps
    (B, 68, H/4, W/4)."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        self.conv2 = FANConvBlock(64, 128)
        self.conv3 = FANConvBlock(128, 128)
        self.conv4 = FANConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlassFAN(4, 256))
            self.add_module(f"top_m_{i}", FANConvBlock(256, 256))
            self.add_module(f"conv_last{i}", conv(256, 256, 1))
            self.add_module(f"bn_end{i}", BatchNorm(256))
            self.add_module(f"l{i}", conv(256, 68, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", conv(256, 256, 1))
                self.add_module(f"al{i}", conv(68, 256, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.avg_pool2d(self.conv2(h), 2, 2)
        previous = self.conv4(self.conv3(h))
        out = None
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return out


def heatmaps_to_landmarks(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, 68, H, W) heatmaps -> (B, 68, 2) xy in the network input's
    pixels: the argmax of each map (the first on ties), a 0.25-pixel step
    along the sign of the neighbours' difference (clamped at the edges),
    then (p + 0.5) x 4."""
    B, K, H, W = heatmaps.shape
    hm = heatmaps.reshape(B, K, H * W)
    idx = torch.argmax(hm, dim=-1)
    y, x = idx // W, idx % W

    def take(yy, xx):
        return torch.gather(hm, 2, (yy * W + xx)[..., None])[..., 0]

    dx = torch.sign(take(y, (x + 1).clamp(0, W - 1)) - take(y, (x - 1).clamp(0, W - 1))) * 0.25
    dy = torch.sign(take((y + 1).clamp(0, H - 1), x) - take((y - 1).clamp(0, H - 1), x)) * 0.25
    return (torch.stack([x + dx, y + dy], dim=-1) + 0.5) * 4.0


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def _checkpoint(path: str) -> dict:
    """A state_dict file without BatchNorm's ``num_batches_tracked``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _loaded(model: nn.Module, sd: dict, device) -> nn.Module:
    dev = resolve_device(device)
    set_float32_math()
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def load_s3fd(path: str, device=None) -> S3FD:
    """S3FD from face-alignment's ``s3fd.pth``, on ``device`` (None: the card)."""
    resolve_device(device)
    return _loaded(S3FD(), _checkpoint(path), device)


def load_bisenet(path: str, device=None) -> BiSeNet:
    """BiSeNet from face-parsing's ``79999_iter.pth`` (its auxiliary heads
    dropped; the class count from ``conv_out.conv_out``), on ``device``."""
    resolve_device(device)
    sd = {k: v for k, v in _checkpoint(path).items() if not k.startswith(("conv_out16.",
                                                                          "conv_out32."))}
    return _loaded(BiSeNet(int(sd["conv_out.conv_out.weight"].shape[0])), sd, device)


def load_fan(path: str, device=None) -> FAN:
    """FAN from a 2DFAN checkpoint; the stack's depth is the count of its
    ``l{i}`` heads, as the JAX pipeline reads it (rvc_tpu/pipelines/
    musetalk.py:282-284), on ``device``."""
    resolve_device(device)
    sd = _checkpoint(path)
    heads = {k.split(".")[0] for k in sd if k.split(".")[0][:1] == "l"
             and k.split(".")[0][1:].isdigit()}
    return _loaded(FAN(len(heads)), sd, device)
