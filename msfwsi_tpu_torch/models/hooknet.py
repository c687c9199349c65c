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
fp32 and the result in the input's dtype (``normalize_fp32``).

``packed_tail`` runs decoder blocks ``>= packed_from`` (3 by default: the
narrow C=32 and C=16 blocks at half and full resolution) in the 2x2
space-to-depth domain of ``ops/s2d.py``, as the JAX package's packed tail
does. It is exact and uses the same modules: each block computes with its
own ``nn.Conv2d`` weights through packed kernels built from them, and with
its own :class:`BatchNorm` through :func:`packed_batch_norm`, so the
``state_dict`` keys are the same packed or not, a checkpoint loads either
way, :func:`..models.resnet.sync_batchnorm` reaches the packed statistics
and one module can train packed and validate unpacked (:func:`unpacked`).
The first convolution of each packed block takes the upsample and the
skip's shuffle into its kernels (the fused entry; the unfused form stays
as :meth:`DecoderBlock.forward_packed`'s ``fused_entry=False``, as the
JAX package keeps it on ``PackedDecoderBlock``); with ``packed_logits`` the
head returns the packed ``(B, H/2, W/2, 4*classes)`` logits for
``ops.losses.dice_loss_packed``, else logical logits.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import s2d
from .resnet import BatchNorm, get_encoder, torch_style_init

__all__ = ["Conv2dReLU", "DecoderBlock", "UnetDecoder", "SegmentationHead", "ContextUnet",
           "TargetUnet", "HookNet", "build_hooknet", "hooknet_init", "packed_batch_norm",
           "configure_tail", "unpacked", "PACKED_FROM"]

DECODER_CHANNELS = (256, 128, 64, 32, 16)
EXPORT_BLOCK = 1  # the context decoder block whose centre crop is the hook
PACKED_FROM = 3  # the first decoder block run packed under packed_tail


def packed_batch_norm(bn: BatchNorm, xp):
    """``bn`` on a packed (B, 4C, h, w) activation, as the JAX package's
    ``_PackedBN``: in train mode the statistics of each logical channel over
    its four sub-positions, batch and pixels (the logical element set), in
    fp32 as the mean and the mean of squares, averaged over ``bn.group``
    when set, the running stats updated with the biased variance at
    ``bn.momentum``; then the normalization as one folded fp32 affine
    ``x*a + b`` (``a = scale*rsqrt(var+eps)``, ``b = bias - mean*a``) on
    the (4C,) tiled parameters, rounded once to the input's dtype. The
    statistics are :meth:`BatchNorm.batch_stats` on the (B, 4, C, h, w)
    view."""
    ct = torch.promote_types(xp.dtype, torch.float32)  # fp64 stays fp64
    if bn.training:
        xf = s2d.packed_bn_view(xp, bn.running_mean.numel()).to(ct)
        mean, var = bn.batch_stats(xf, (0, 1, 3, 4))
    else:
        mean, var = bn.running_mean, bn.running_var
    # autocast runs rsqrt in fp32 whatever its input: cast back to ct.
    a = bn.weight.to(ct) * torch.rsqrt(var.to(ct) + bn.eps).to(ct)
    b = bn.bias.to(ct) - mean.to(ct) * a
    y = xp.to(ct) * s2d.tile_params(a).view(1, -1, 1, 1) + s2d.tile_params(b).view(1, -1, 1, 1)
    return y.to(xp.dtype)


def _kernel_autocast_off(x):
    """Packed kernels are built in the weights' dtype (fp32) with autocast
    off, as the JAX package builds them before its cast; the convolution
    then casts the kernel once."""
    return torch.autocast(x.device.type, enabled=False)


def _packed_conv_bn_relu(layer: "Conv2dReLU", xp):
    """``layer`` (conv 3x3, BatchNorm, ReLU) on a packed activation."""
    with _kernel_autocast_off(xp):
        k = s2d.pack_conv3x3_kernel(layer[0].weight)
    return F.relu(packed_batch_norm(layer[1], F.conv2d(xp, k, padding=1)))


def _pack_grouped_kernel(w, in_groups):
    """Packed kernel of an input that concatenates independently packed
    groups: each logical input-channel slice packed apart, concatenated on
    the packed input channels."""
    parts, lo = [], 0
    for g in in_groups:
        parts.append(s2d.pack_conv3x3_kernel(w[:, lo:lo + g]))
        lo += g
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _packed_upsample2x(xp):
    """Nearest 2x upsample of a packed activation, emitted packed: a
    depth-to-space whose every sub-position block is broadcast to all four
    output sub-positions (the unfused entry's shuffle)."""
    B, C4, h, w = xp.shape
    t = xp.reshape(B, 4, 1, C4 // 4, h, w).expand(B, 4, 4, C4 // 4, h, w)
    return s2d.depth_to_space(t.reshape(B, 4 * C4, h, w))


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

    def forward_packed(self, x, skip=None, x_packed: bool = False, fused_entry: bool = True):
        """The block in the space-to-depth domain, on the same modules:
        ``x`` packed (``x_packed``) or logical (the first packed block),
        ``skip`` logical; returns the packed output. With ``fused_entry``
        the first convolution takes the upsample and the skip's shuffle
        into its kernels: a packed ``x`` through one ``conv_transpose2d``
        (stride 2, padding 1: the JAX package's ``lhs_dilation=(2, 2)``
        conv), a logical one as a channel tile and the packed conv, the
        skip through a 4x4 stride-2 conv, summed; without, the upsample and
        the skip's space-to-depth are materialized and concatenated."""
        conv, bn = self.conv1[0], self.conv1[1]
        in_ch = conv.in_channels - (0 if skip is None else skip.shape[1])
        with _kernel_autocast_off(x):
            w = conv.weight
            if fused_entry:
                kx = (s2d.pack_upconv3x3_kernel if x_packed else s2d.pack_conv3x3_kernel)(
                    w[:, :in_ch])
                ks = None if skip is None else s2d.pack_skipconv3x3_kernel(w[:, in_ch:])
            else:
                groups = [in_ch] + ([] if skip is None else [skip.shape[1]])
                k = _pack_grouped_kernel(w, groups)
        if fused_entry:
            if x_packed:
                y = F.conv_transpose2d(x, kx, stride=2, padding=1)
            else:
                y = F.conv2d(s2d.upsample2x_packed(x), kx, padding=1)
            if skip is not None:
                y = y + F.conv2d(skip, ks, stride=2, padding=1)
        else:
            xp = _packed_upsample2x(x) if x_packed else s2d.upsample2x_packed(x)
            if skip is not None:
                xp = torch.cat([xp, s2d.space_to_depth(skip).to(xp.dtype)], dim=1)
            y = F.conv2d(xp, k, padding=1)
        y = F.relu(packed_batch_norm(bn, y))
        return _packed_conv_bn_relu(self.conv2, y)


class UnetDecoder(nn.Module):
    """U-Net decoder over the 5-level pyramid (NCHW). The pyramid is
    reversed: the encoder head enters block 0 and the /16, /8, /4, /2
    levels are the skips of blocks 0-3; block 4 has none. ``context_ch``
    > 0: the context features are concatenated onto the head (target
    branch). ``export_block``: also return the centre H/4 crop of that
    block's output (context branch). ``packed_tail``: blocks from
    ``packed_from`` on run packed, through the fused entry, and the output
    is packed (B, 4C, H/2, W/2)."""

    def __init__(self, pyramid_dims: Sequence[int], context_ch: int = 0,
                 export_block: int | None = None, packed_tail: bool = False,
                 packed_from: int = PACKED_FROM):
        super().__init__()
        dims = list(pyramid_dims)[::-1]
        skips = dims[1:] + [0]
        ins = [dims[0] + context_ch, *DECODER_CHANNELS[:-1]]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in zip(ins, skips, DECODER_CHANNELS))
        self.context_ch = context_ch
        self.export_block = export_block
        self.packed_tail = packed_tail
        self.packed_from = packed_from

    def forward(self, pyramid, context_feats=None):
        feats = list(pyramid)[::-1]
        x, skips = feats[0], feats[1:]
        if self.context_ch:
            if context_feats is None:
                raise ValueError("target decoder requires context_feats")
            x = torch.cat([x, context_feats.to(x.dtype)], dim=1)
        if self.packed_tail and self.export_block is not None:
            # a packed hook would crop the (h/2, w/2, 4C) tensor and hand a
            # wrong layout to the target branch
            if self.export_block >= self.packed_from:
                raise ValueError(
                    f"hook export block {self.export_block} must run in the "
                    f"logical domain (packed_from={self.packed_from})"
                )
        exported = None
        packed = False
        for i, block in enumerate(self.blocks):
            skip = skips[i] if i < len(skips) else None
            if self.packed_tail and i >= self.packed_from:
                x = block.forward_packed(x, skip, x_packed=packed)
                packed = True
            else:
                x = block(x, skip)
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

    def forward_packed(self, xp, emit_packed: bool = False):
        """The head on a packed decoder output: logical (B, classes, H, W)
        logits through a final depth-to-space, or with ``emit_packed`` the
        packed (B, 4*classes, H/2, W/2) ones."""
        conv = self[0]
        with _kernel_autocast_off(xp):
            k, b = s2d.pack_conv3x3_kernel(conv.weight), s2d.tile_params(conv.bias)
        y = F.conv2d(xp, k, b, padding=1)
        return y if emit_packed else s2d.depth_to_space(y)


class _Branch(nn.Module):
    def __init__(self, arch: str, classes: int, remat: bool = False, packed_tail: bool = False,
                 packed_from: int = PACKED_FROM, packed_logits: bool = False, **decoder_kw):
        super().__init__()
        self.encoder = get_encoder(arch, remat=remat)
        self.decoder = UnetDecoder(self.encoder.pyramid_dims, packed_tail=packed_tail,
                                   packed_from=packed_from, **decoder_kw)
        self.segmentation_head = SegmentationHead(DECODER_CHANNELS[-1], classes)
        self.packed_logits = packed_logits

    def head(self, decoded):
        if self.decoder.packed_tail:
            return self.segmentation_head.forward_packed(decoded, self.packed_logits)
        return self.segmentation_head(decoded)


class ContextUnet(_Branch):
    """Low-magnification branch: NHWC images -> (NCHW logits, NCHW hook)."""

    def __init__(self, arch="resnet18", classes=6, remat: bool = False, **tail_kw):
        super().__init__(arch, classes, remat, export_block=EXPORT_BLOCK, **tail_kw)

    def forward(self, x):
        decoded, context_feats = self.decoder(self.encoder.pyramid_nchw(x))
        return self.head(decoded), context_feats


class TargetUnet(_Branch):
    """High-magnification branch consuming the context hook."""

    def __init__(self, arch="resnet18", classes=6, remat: bool = False, **tail_kw):
        super().__init__(arch, classes, remat, context_ch=DECODER_CHANNELS[EXPORT_BLOCK],
                         **tail_kw)

    def forward(self, x, context_feats):
        return self.head(self.decoder(self.encoder.pyramid_nchw(x), context_feats))


class HookNet(nn.Module):
    """``HookNet(x_context, x_target) -> (context_logits, target_logits)``,
    images and logits NHWC, ``classes = len(class_names) + 1`` with
    background 0 (``ssl_finetune.py:144``). ``remat``: per-block activation
    checkpointing of both branch encoders (``ResNet``). ``packed_tail``,
    ``packed_from`` and ``packed_logits`` (the logits then (B, H/2, W/2,
    4*classes)): see the module's docstring and :func:`configure_tail`."""

    def __init__(self, arch: str = "resnet18", classes: int = 6, remat: bool = False,
                 packed_tail: bool = False, packed_from: int = PACKED_FROM,
                 packed_logits: bool = False):
        super().__init__()
        kw = dict(packed_tail=packed_tail, packed_from=packed_from, packed_logits=packed_logits)
        self.context_branch = ContextUnet(arch, classes, remat, **kw)
        self.target_branch = TargetUnet(arch, classes, remat, **kw)

    @property
    def packed_tail(self) -> bool:
        return self.target_branch.decoder.packed_tail

    @property
    def emits_packed_logits(self) -> bool:
        """Whether the logits come packed (packed tail and packed logits)."""
        return self.packed_tail and self.target_branch.packed_logits

    def forward(self, x_context, x_target):
        ctx_logits, context_feats = self.context_branch(x_context)
        tgt_logits = self.target_branch(x_target, context_feats)
        return ctx_logits.permute(0, 2, 3, 1), tgt_logits.permute(0, 2, 3, 1)


def configure_tail(model: nn.Module, packed_tail: bool, packed_from: int | None = None,
                   packed_logits: bool = False) -> nn.Module:
    """Set the decoder tail of every branch of ``model`` in place: packed
    or not, from which block (None keeps it), and whether the head emits
    packed logits. The parameters and buffers are untouched."""
    for m in model.modules():
        if isinstance(m, UnetDecoder):
            m.packed_tail = packed_tail
            if packed_from is not None:
                m.packed_from = packed_from
        elif isinstance(m, _Branch):
            m.packed_logits = packed_logits
    return model


@contextlib.contextmanager
def unpacked(model: nn.Module):
    """Run ``model`` with its unpacked decoder and logical logits inside
    the block (validation of a model that trains packed), its tail restored
    after."""
    saved = [(m, m.packed_tail) for m in model.modules() if isinstance(m, UnetDecoder)]
    logits = [(m, m.packed_logits) for m in model.modules() if isinstance(m, _Branch)]
    configure_tail(model, False)
    try:
        yield model
    finally:
        for m, v in saved:
            m.packed_tail = v
        for m, v in logits:
            m.packed_logits = v


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
