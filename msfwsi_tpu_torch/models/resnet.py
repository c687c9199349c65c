"""Multi-scale ResNet encoders in PyTorch (pooled and pyramid modes).

Port of ``msfwsi_tpu/models/resnet.py``: the torchvision layout and
parameter names (so ``state_dict`` keys are the reference's), the
torch-style init, and BatchNorm with the JAX package's semantics. The
public input is NHWC, as in the JAX package; inside, the convolutions run
on NCHW views in ``channels_last`` memory, which an NHWC tensor already is.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["BatchNorm", "BasicBlock", "Bottleneck", "ResNet", "ARCH_SPECS", "feature_dims",
           "get_encoder", "torch_style_init"]


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with the JAX package's semantics: statistics in
    fp32 (float64 for a float64 input) as mean and mean-of-squares, the
    *biased* batch variance, running stats updated as ``m*ra +
    (1-m)*batch`` with flax momentum ``m = 0.9``,
    and the output in the input's dtype. The normalization arithmetic runs
    in the input's dtype, as the encoders' ``BatchNormNamedStats`` does, or
    with ``normalize_fp32`` in fp32, as flax ``nn.BatchNorm`` in the heads
    does. (torch's own ``F.batch_norm`` would store the unbiased variance.)"""

    momentum = 0.9  # flax convention: the share kept of the running stat
    eps = 1e-5

    def __init__(self, num_features: int, affine: bool = True, zero_init: bool = False,
                 normalize_fp32: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.normalize_fp32 = normalize_fp32
        if affine:
            self.weight = nn.Parameter(torch.empty(num_features))
            self.bias = nn.Parameter(torch.empty(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))
        self.reset_parameters()

    def reset_parameters(self):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(0.0 if self.zero_init else 1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            dims = [0, *range(2, x.dim())]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # fp64 stays fp64
            mean = xf.mean(dim=dims)
            var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        dt = x.dtype
        ct = torch.float32 if self.normalize_fp32 else dt
        # autocast runs rsqrt in fp32 whatever its input: cast back to ct.
        mul = torch.rsqrt(var.to(ct) + self.eps).to(ct)
        if self.weight is not None:
            mul = mul * self.weight.to(ct)
        y = (x.to(ct) - mean.to(ct).view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.to(ct).view(shape)
        return y.to(dt)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_projection: bool = False, zero_init_residual: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError(f"BasicBlock only supports groups=1 and base_width=64, got "
                             f"groups={groups}, base_width={base_width}")
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, zero_init=zero_init_residual)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), BatchNorm(planes)
            )
            if use_projection
            else None
        )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (expansion 4), the stride on the 3x3 and
    its convolution grouped (``groups``); inner width
    ``int(planes * base_width / 64) * groups``, as torchvision's."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_projection: bool = False, zero_init_residual: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups,
                               bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm(out, zero_init=zero_init_residual)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, out, 1, stride=stride, bias=False), BatchNorm(out))
            if use_projection
            else None
        )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """ResNet whose forward takes NHWC images and returns, with
    ``features="pooled"`` (the default), the 4-tuple of stage-wise
    global-average-pooled (B, C_i) features (the reference's
    ``return_features=True`` path), or with ``features="pyramid"`` the
    5-level NHWC feature pyramid (stem/2, layer1/4, layer2/8, layer3/16,
    layer4/32) of the smp encoders that HookNet decodes; the stem level is
    taken after ``relu(bn1(conv1))``, before the max-pool."""

    def __init__(self, stage_sizes, block_cls=BasicBlock, zero_init_residual: bool = False,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, num_blocks in enumerate(stage_sizes):
            planes = 64 * 2**i
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                needs_proj = j == 0 and (stride != 1 or inplanes != planes * block_cls.expansion)
                blocks.append(block_cls(inplanes, planes, stride, needs_proj, zero_init_residual,
                                        groups, width_per_group))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        e = block_cls.expansion
        self.feature_dims = (64 * e, 128 * e, 256 * e, 512 * e)
        self.pyramid_dims = (64, *self.feature_dims)

    def pyramid_nchw(self, x):
        """The 5-level pyramid of NHWC images ``x`` as NCHW views of
        ``channels_last`` memory (the layout the decoders compute in)."""
        x = x.permute(0, 3, 1, 2)  # NHWC data seen as an NCHW channels_last view
        stem = torch.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(stem)
        levels = [stem]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            levels.append(x)
        return levels

    def forward(self, x, features: str = "pooled"):
        levels = self.pyramid_nchw(x)
        if features == "pyramid":
            return tuple(f.permute(0, 2, 3, 1) for f in levels)
        if features == "pooled":
            return tuple(f.mean(dim=(2, 3)) for f in levels[1:])
        raise ValueError(f"unknown features mode: {features!r}")


# arch -> (block, stage_sizes, extra ResNet kwargs): the JAX package's table
# (the reference's factories, src/models/resnet.py:278-388); resnet10 (one
# block per stage) keeps the 4-stage contract at the smallest size.
ARCH_SPECS = {
    "resnet10": (BasicBlock, (1, 1, 1, 1), {}),
    "resnet18": (BasicBlock, (2, 2, 2, 2), {}),
    "resnet34": (BasicBlock, (3, 4, 6, 3), {}),
    "resnet50": (Bottleneck, (3, 4, 6, 3), {}),
    "resnet101": (Bottleneck, (3, 4, 23, 3), {}),
    "resnet152": (Bottleneck, (3, 8, 36, 3), {}),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), {"groups": 32, "width_per_group": 4}),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), {"groups": 32, "width_per_group": 8}),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), {"width_per_group": 128}),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), {"width_per_group": 128}),
}


def feature_dims(arch: str) -> tuple[int, int, int, int]:
    """Per-stage pooled feature channels of ``arch`` (the block's expansion
    counted, as ``ResNet.feature_dims``), without building the encoder."""
    if arch not in ARCH_SPECS:
        raise ValueError(f"unknown arch {arch!r}; the port has {sorted(ARCH_SPECS)}")
    e = ARCH_SPECS[arch][0].expansion
    return (64 * e, 128 * e, 256 * e, 512 * e)


def get_encoder(arch: str, **kwargs) -> ResNet:
    if arch not in ARCH_SPECS:
        raise ValueError(f"unknown arch {arch!r}; the port has {sorted(ARCH_SPECS)}")
    block_cls, stage_sizes, extra = ARCH_SPECS[arch]
    return ResNet(stage_sizes, block_cls, **extra, **kwargs)


def torch_style_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and buffer from ``generator``, as torch
    (and the JAX package) do: convs kaiming-normal with fan_out and ReLU
    gain, linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    BatchNorm scale 1 (0 for zero-init residual branches) and bias 0,
    running stats 0 and 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
    return module
