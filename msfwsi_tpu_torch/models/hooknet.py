"""HookNet segmentation model in PyTorch: two coupled U-Nets.

Port of ``msfwsi_tpu/models/hooknet.py`` (reference: ``src/models/hooknet.py``
on segmentation_models_pytorch's Unet). Module names are smp's, so the
``state_dict`` carries the reference's keys (``context_branch.encoder...``,
``decoder.blocks.{i}.conv{1,2}.{0,1}...``, ``segmentation_head.0...``).

  * Each branch: a ResNet encoder in pyramid mode, a U-Net decoder of
    [nearest 2x upsample, concat skip, (Conv3x3-BN-ReLU) x 2] blocks and a
    3x3 conv segmentation head.
  * The context branch exports the centre H/4 crop of its decoder block 1
    output (the 8x8 centre of the 32x32, 128-channel map at 256 px); the
    target branch concatenates it onto its encoder head before decoding.

Images and logits are NHWC at the API, as in the JAX package; inside, the
convolutions run on NCHW views of ``channels_last`` memory. The decoder's
BatchNorm is flax ``nn.BatchNorm``: fp32 statistics, the normalization in
fp32 and the result in the input's dtype (``normalize_fp32``). The JAX
package's space-to-depth decoder tail (``packed_tail``) only removes the
TPU's 128-lane padding and is exact with the same variables, so the port
has the unpacked form alone.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm, get_encoder, torch_style_init

__all__ = ["Conv2dReLU", "DecoderBlock", "UnetDecoder", "SegmentationHead", "ContextUnet",
           "TargetUnet", "HookNet", "build_hooknet", "hooknet_init"]

DECODER_CHANNELS = (256, 128, 64, 32, 16)
EXPORT_BLOCK = 1  # the context decoder block whose centre crop is the hook


class Conv2dReLU(nn.Sequential):
    """smp Conv2dReLU: 3x3 conv without bias, BatchNorm, ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm(out_ch, normalize_fp32=True),
            nn.ReLU(),
        )


class DecoderBlock(nn.Module):
    """smp DecoderBlock: nearest 2x upsample, concat skip, 2x Conv2dReLU."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = Conv2dReLU(in_ch + skip_ch, out_ch)
        self.conv2 = Conv2dReLU(out_ch, out_ch)

    def forward(self, x, skip=None):
        # CUDA autocast runs upsample_nearest2d in fp32; a nearest copy is
        # exact in any dtype, so keep the input's (bf16 under amp, as the
        # JAX package's repeat), not an fp32 copy four times its size.
        with torch.autocast(x.device.type, enabled=False):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    """U-Net decoder over the 5-level pyramid (NCHW). The pyramid is
    reversed: the encoder head enters block 0 and the /16, /8, /4, /2
    levels are the skips of blocks 0-3; block 4 has none. ``context_ch``
    > 0: the context features are concatenated onto the head (target
    branch). ``export_block``: also return the centre H/4 crop of that
    block's output (context branch)."""

    def __init__(self, pyramid_dims: Sequence[int], context_ch: int = 0,
                 export_block: int | None = None):
        super().__init__()
        dims = list(pyramid_dims)[::-1]
        skips = dims[1:] + [0]
        ins = [dims[0] + context_ch, *DECODER_CHANNELS[:-1]]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in zip(ins, skips, DECODER_CHANNELS))
        self.context_ch = context_ch
        self.export_block = export_block

    def forward(self, pyramid, context_feats=None):
        feats = list(pyramid)[::-1]
        x, skips = feats[0], feats[1:]
        if self.context_ch:
            if context_feats is None:
                raise ValueError("target decoder requires context_feats")
            x = torch.cat([x, context_feats.to(x.dtype)], dim=1)
        exported = None
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
            if i == self.export_block:  # the centre H/4 crop: 12:20 of 32
                h = x.shape[2]
                c0, c1 = h // 2 - h // 8, h // 2 + h // 8
                exported = x[:, :, c0:c1, c0:c1]
        return x if self.export_block is None else (x, exported)


class SegmentationHead(nn.Sequential):
    """smp SegmentationHead: a 3x3 conv with bias (its upsampling and
    activation are identities)."""

    def __init__(self, in_ch: int, classes: int):
        super().__init__(nn.Conv2d(in_ch, classes, 3, padding=1))


class _Branch(nn.Module):
    def __init__(self, arch: str, classes: int, remat: bool = False, **decoder_kw):
        super().__init__()
        self.encoder = get_encoder(arch, remat=remat)
        self.decoder = UnetDecoder(self.encoder.pyramid_dims, **decoder_kw)
        self.segmentation_head = SegmentationHead(DECODER_CHANNELS[-1], classes)


class ContextUnet(_Branch):
    """Low-magnification branch: NHWC images -> (NCHW logits, NCHW hook)."""

    def __init__(self, arch="resnet18", classes=6, remat: bool = False):
        super().__init__(arch, classes, remat, export_block=EXPORT_BLOCK)

    def forward(self, x):
        decoded, context_feats = self.decoder(self.encoder.pyramid_nchw(x))
        return self.segmentation_head(decoded), context_feats


class TargetUnet(_Branch):
    """High-magnification branch consuming the context hook."""

    def __init__(self, arch="resnet18", classes=6, remat: bool = False):
        super().__init__(arch, classes, remat, context_ch=DECODER_CHANNELS[EXPORT_BLOCK])

    def forward(self, x, context_feats):
        return self.segmentation_head(self.decoder(self.encoder.pyramid_nchw(x), context_feats))


class HookNet(nn.Module):
    """``HookNet(x_context, x_target) -> (context_logits, target_logits)``,
    images and logits NHWC, ``classes = len(class_names) + 1`` with
    background 0 (``ssl_finetune.py:144``). ``remat``: per-block activation
    checkpointing of both branch encoders (``ResNet``)."""

    def __init__(self, arch: str = "resnet18", classes: int = 6, remat: bool = False):
        super().__init__()
        self.context_branch = ContextUnet(arch, classes, remat)
        self.target_branch = TargetUnet(arch, classes, remat)

    def forward(self, x_context, x_target):
        ctx_logits, context_feats = self.context_branch(x_context)
        tgt_logits = self.target_branch(x_target, context_feats)
        return ctx_logits.permute(0, 2, 3, 1), tgt_logits.permute(0, 2, 3, 1)


def hooknet_init(model: HookNet, generator: torch.Generator) -> HookNet:
    """The reference's init, drawn from ``generator``: the encoders as torch
    initializes a ResNet (:func:`torch_style_init`), the decoder convs
    kaiming-uniform (fan_in, ReLU gain) and the heads xavier-uniform with a
    zero bias (smp ``initialize_decoder`` / ``initialize_head``), every
    BatchNorm at scale 1, bias 0, running stats 0 and 1."""
    with torch.no_grad():
        for branch in (model.context_branch, model.target_branch):
            torch_style_init(branch.encoder, generator)
            for m in branch.decoder.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    bound = math.sqrt(6.0 / fan_in)
                    m.weight.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, BatchNorm):
                    m.reset_parameters()
            conv = branch.segmentation_head[0]
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            fan_out = conv.out_channels * conv.kernel_size[0] * conv.kernel_size[1]
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            conv.weight.uniform_(-bound, bound, generator=generator)
            conv.bias.zero_()
    return model


def build_hooknet(generator: torch.Generator, device="cpu", **kwargs) -> HookNet:
    """A :class:`HookNet` initialized from ``generator`` (a CPU generator,
    so a seed gives the same weights on every device) and moved to
    ``device``."""
    with torch.device("meta"):
        model = HookNet(**kwargs)
    model = hooknet_init(model.to_empty(device="cpu"), generator)
    return model.to(device)
