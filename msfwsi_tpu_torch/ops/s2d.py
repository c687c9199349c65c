"""Space-to-depth packing of the HookNet decoder tail (port of
``msfwsi_tpu/ops/s2d.py``, NCHW).

A logical ``(B, C, H, W)`` activation becomes ``(B, 4C, H/2, W/2)``: the
same values, with each 2x2 block of pixels moved onto the channels. The
transformation is exact: a logical SAME stride-1 3x3 convolution equals a
SAME stride-1 3x3 convolution in the packed domain with a structured
``(4*Cout, 4*Cin, 3, 3)`` kernel built from the logical ``(Cout, Cin, 3, 3)``
weight (:func:`pack_conv3x3_kernel`), at 4x the multiply-adds. BatchNorm
statistics group the four sub-positions of each logical channel, so they
reduce over the same element set as the logical BatchNorm
(:func:`packed_bn_view`, :func:`tile_params`).

Packed channels are **sub-position-major**: packed channel ``p*C + c``
holds logical channel ``c`` at sub-position ``p = py*2 + px``. With this
order a nearest 2x upsample followed by space-to-depth is a channel tile
(:func:`upsample2x_packed`). (``F.pixel_unshuffle`` orders the channels
``c*4 + p`` and is not this.)

The functions take and return NCHW tensors and work through NHWC views, so
a ``channels_last`` input gives a ``channels_last`` output, one copy. The
kernel builders are einsums of the logical weight against constant 0/1
route tensors (built here with numpy, as the JAX package builds them), so
a gradient reaches the logical weight.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "space_to_depth",
    "depth_to_space",
    "upsample2x_packed",
    "pack_conv3x3_kernel",
    "pack_upconv3x3_kernel",
    "pack_skipconv3x3_kernel",
    "tile_params",
    "packed_bn_view",
]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), sub-position-major channels:
    ``out[b, (py*2+px)*C + c, i, j] == x[b, c, 2i+py, 2j+px]``."""
    B, C, H, W = x.shape
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    y = x.permute(0, 2, 3, 1).reshape(B, H // 2, 2, W // 2, 2, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
    return y.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`: (B, 4C, h, w) -> (B, C, 2h, 2w)."""
    B, C4, h, w = x.shape
    assert C4 % 4 == 0, C4
    C = C4 // 4
    y = x.permute(0, 2, 3, 1).reshape(B, h, w, 2, 2, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * h, 2 * w, C)
    return y.permute(0, 3, 1, 2)


def upsample2x_packed(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample emitted in the packed domain:
    ``space_to_depth(upsample2x_nearest(x))`` is ``x`` tiled 4 times on the
    channels, since nearest upsampling writes ``x[i, j]`` to all four
    sub-positions of output block ``(i, j)``."""
    return x.permute(0, 2, 3, 1).repeat(1, 1, 1, 4).permute(0, 3, 1, 2)


def _build_route() -> np.ndarray:
    """(u, v, p_in, q_out, dy, dx) -> 1 where logical tap (dy, dx) lands for
    a packed SAME 3x3 conv: logical output row ``2i + oy`` reads logical
    row ``2i + oy + dy - 1``, which packed tap ``u`` holds at sub-position
    ``py`` when ``dy = 2u + py - oy - 1``; the same for columns."""
    route = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for oy in range(2):
        for ox in range(2):
            for u in range(3):
                for v in range(3):
                    for py in range(2):
                        dy = 2 * u + py - oy - 1
                        if not 0 <= dy <= 2:
                            continue
                        for px in range(2):
                            dx = 2 * v + px - ox - 1
                            if not 0 <= dx <= 2:
                                continue
                            route[u, v, py * 2 + px, oy * 2 + ox, dy, dx] = 1.0
    return route


def _build_up_route() -> np.ndarray:
    """Routing of [nearest 2x upsample -> SAME 3x3 conv] as one
    ``lhs_dilation=(2, 2)``, pad (2, 2) conv from the packed input to the
    packed output at twice the packed grid (the JAX package's derivation):
    output packed row ``I`` holds logical rows ``2I + qy``, reading upsampled
    row ``2I + qy + dy - 1``, i.e. source row ``a = (2I + qy + dy - 1) // 2``
    at packed row ``a // 2``, sub-position ``a % 2``, dilated tap
    ``u = 2(a // 2) - I + 2``. Two taps that read one duplicated source
    pixel sum into one slot."""
    route = np.zeros((4, 4, 4, 4, 3, 3), np.float32)  # u, v, p_in, q_out, dy, dx
    for i0 in (0, 1):
        for j0 in (0, 1):
            for qy in (0, 1):
                for dy in range(3):
                    I = 2 + i0
                    a = (2 * I + qy + dy - 1) // 2
                    py, u = a % 2, 2 * (a // 2) - I + 2
                    for qx in (0, 1):
                        for dx in range(3):
                            J = 2 + j0
                            b = (2 * J + qx + dx - 1) // 2
                            px, v = b % 2, 2 * (b // 2) - J + 2
                            route[u, v, py * 2 + px, qy * 2 + qx, dy, dx] += 1
    return route


def _build_skip_route() -> np.ndarray:
    """Routing of ``space_to_depth(conv3x3_SAME(skip))`` as one window-4,
    stride-2, pad-1 conv on the logical skip: output packed row ``i`` holds
    logical rows ``2i + qy``, reading ``2i + qy + dy - 1``, tap ``u = qy + dy``."""
    route = np.zeros((4, 4, 4, 3, 3), np.float32)  # u, v, q_out, dy, dx
    for qy in (0, 1):
        for dy in range(3):
            for qx in (0, 1):
                for dx in range(3):
                    route[qy + dy, qx + dx, qy * 2 + qx, dy, dx] += 1
    return route


_ROUTES = {
    "conv": _build_route(),
    # conv_transpose2d(stride 2, padding 1) is the lhs-dilated conv with
    # its kernel flipped on both spatial axes: flip the route once here.
    "up": np.ascontiguousarray(_build_up_route()[::-1, ::-1]),
    "skip": _build_skip_route(),
}


_ON_DEVICE: dict = {}


def _route(name: str, w: torch.Tensor) -> torch.Tensor:
    """The route tensor ``name`` on ``w``'s device and in its dtype, copied
    there once: a copy from host memory at every forward would stall the
    host until the device drains its queue."""
    key = (name, w.device, w.dtype)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(_ROUTES[name]).to(device=w.device, dtype=w.dtype)
    return _ON_DEVICE[key]


def pack_conv3x3_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) logical weight -> (4*Cout, 4*Cin, 3, 3): a SAME
    stride-1 conv with it on ``space_to_depth(x)`` equals
    ``space_to_depth(conv3x3_SAME(x, w))``. SAME padding in the packed
    domain pads one block (two logical pixels); the outer logical ring gets
    no tap, so the boundary is the logical SAME pad."""
    Cout, Cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    packed = torch.einsum("uvpqyx,oiyx->qopiuv", _route("conv", w), w)
    return packed.reshape(4 * Cout, 4 * Cin, 3, 3)


def pack_upconv3x3_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) logical weight -> the (4*Cin, 4*Cout, 4, 4)
    ``F.conv_transpose2d`` weight of [nearest 2x upsample -> SAME 3x3 conv]
    from a packed ``(B, 4Cin, h, w)`` input to the packed ``(B, 4Cout, 2h,
    2w)`` output: ``conv_transpose2d(x, k, stride=2, padding=1)``, the
    JAX package's ``lhs_dilation=(2, 2)``, pad (2, 2) conv."""
    Cout, Cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    packed = torch.einsum("uvpqyx,oiyx->piqouv", _route("up", w), w)
    return packed.reshape(4 * Cin, 4 * Cout, 4, 4)


def pack_skipconv3x3_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) logical weight -> (4*Cout, Cin, 4, 4): a conv with
    stride 2 and padding 1 on the logical ``(B, Cin, 2h, 2w)`` skip gives
    ``space_to_depth(conv3x3_SAME(skip, w))`` without the skip's shuffle."""
    Cout, Cin, kh, kw = w.shape
    assert kh == 3 and kw == 3, (kh, kw)
    packed = torch.einsum("uvqyx,oiyx->qoiuv", _route("skip", w), w)
    return packed.reshape(4 * Cout, Cin, 4, 4)


def tile_params(p: torch.Tensor) -> torch.Tensor:
    """Per-logical-channel (C,) parameters -> packed (4C,) (four copies)."""
    return p.repeat(4)


def packed_bn_view(xp: torch.Tensor, C: int) -> torch.Tensor:
    """A packed (B, 4C, h, w) activation as (B, 4, C, h, w): its dims
    (0, 1, 3, 4) span the logical (batch, H, W) element set of channel
    ``c``. A view of a contiguous or ``channels_last`` tensor (splitting
    the channels keeps their strides); a copy only of another layout."""
    B, C4, h, w = xp.shape
    assert C4 == 4 * C, (C4, C)
    return xp.reshape(B, 4, C, h, w)
