"""MSF-WSI dual-branch multi-resolution SimSiam backbone, in PyTorch.

Port of ``msfwsi_tpu/models/backbone.py``. Module and parameter names are
the reference's (``context_projector.0.3.weight`` ...), so the port's
``state_dict`` carries the keys of the reference checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geometry import unshuffle_features
from .resnet import BatchNorm, get_encoder, torch_style_init

__all__ = ["Projector", "Predictor", "MSFWSI", "build_msfwsi"]


def _head_bn(dim: int, affine: bool = True) -> BatchNorm:
    """The heads' BatchNorm: flax ``nn.BatchNorm`` normalizes in fp32 and
    casts the result back to the input's dtype."""
    return BatchNorm(dim, affine=affine, normalize_fp32=True)


class Projector(nn.Sequential):
    """[Linear(no bias)-BN-ReLU] x2 + Linear(no bias) + BN(affine=False)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(
            nn.Linear(in_dim, in_dim, bias=False), _head_bn(in_dim), nn.ReLU(),
            nn.Linear(in_dim, in_dim, bias=False), _head_bn(in_dim), nn.ReLU(),
            nn.Linear(in_dim, out_dim, bias=False), _head_bn(out_dim, affine=False),
        )


class Predictor(nn.Sequential):
    """Linear(no bias)-BN-ReLU + Linear(bias) back to the input width."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__(
            nn.Linear(in_dim, hidden_dim, bias=False), _head_bn(hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, in_dim),
        )


class MSFWSI(nn.Module):
    """Dual-branch multi-resolution SimSiam model.

    ``forward((ctx1, tgt1), (ctx2, tgt2), (rev1, rev2))`` with context views
    (B, S, S, 3), target view stacks (B*K, S, S, 3) and (B, K) inverse
    jigsaw permutations returns ``{"context"|"target"|"fuser": (p1, p2,
    z1, z2)}``, each a 4-scale tuple; the z are detached (stop-gradient).

    ``views_shuffled=True``: target views arrive jigsaw-shuffled and their
    features are un-shuffled with the inverse permutation. ``False``: views
    arrive in spatial order and the shuffle is applied to the features the
    fuser takes instead (the same result for the same permutation).
    """

    def __init__(self, arch: str = "resnet18", scale: int = 4, mask_ratio: float = 0.5,
                 views_shuffled: bool = True):
        super().__init__()
        self.arch = arch
        self.scale = scale
        self.K = int(scale**2)
        self.n_keep = int(self.K * (1 - mask_ratio))
        self.views_shuffled = views_shuffled
        self.context_encoder = get_encoder(arch, zero_init_residual=True)
        self.target_encoder = get_encoder(arch, zero_init_residual=True)
        dims = self.context_encoder.feature_dims
        ms_dims = tuple(d * (self.n_keep + 1) for d in dims)
        for side, ds in (("context", dims), ("target", dims), ("inter", ms_dims)):
            setattr(self, f"{side}_projector", nn.ModuleList(Projector(d, d) for d in ds))
            setattr(self, f"{side}_predictor", nn.ModuleList(Predictor(d, d // 4) for d in ds))

    @staticmethod
    def _heads(projectors, predictors, feats):
        z = tuple(p(f) for p, f in zip(projectors, feats))
        return z, tuple(p(zz) for p, zz in zip(predictors, z))

    def encode_context(self, x):
        """The 4 pooled stage features of NHWC images through the context
        encoder alone; no head is touched."""
        return self.context_encoder(x)

    def encode_target(self, x):
        """The same through the target encoder."""
        return self.target_encoder(x)

    def forward(self, x1, x2, jigsaw_reverse_idx):
        B = x1[0].shape[0]
        K = self.K
        context_f1 = self.encode_context(x1[0])
        context_f2 = self.encode_context(x2[0])
        target_f1 = self.encode_target(x1[1])
        target_f2 = self.encode_target(x2[1])

        t1_split = tuple(f.reshape(B, K, -1) for f in target_f1)
        t2_split = tuple(f.reshape(B, K, -1) for f in target_f2)
        rev1, rev2 = jigsaw_reverse_idx
        if self.views_shuffled:
            t1_sort = tuple(unshuffle_features(f, rev1).reshape(B * K, -1) for f in t1_split)
            t2_sort = tuple(unshuffle_features(f, rev2).reshape(B * K, -1) for f in t2_split)
            fuser1, fuser2 = t1_split, t2_split
        else:
            t1_sort, t2_sort = target_f1, target_f2
            perm1 = rev1.argsort(dim=1)[:, : self.n_keep]
            perm2 = rev2.argsort(dim=1)[:, : self.n_keep]
            fuser1 = tuple(unshuffle_features(f, perm1) for f in t1_split)
            fuser2 = tuple(unshuffle_features(f, perm2) for f in t2_split)

        context_z1, context_p1 = self._heads(self.context_projector, self.context_predictor, context_f1)
        context_z2, context_p2 = self._heads(self.context_projector, self.context_predictor, context_f2)
        target_z1, target_p1 = self._heads(self.target_projector, self.target_predictor, t1_sort)
        target_z2, target_p2 = self._heads(self.target_projector, self.target_predictor, t2_sort)

        # Fuser: context feature ++ the first n_keep still-shuffled target
        # tiles (random masking by virtue of the shuffle).
        ms_f1 = tuple(
            torch.cat((c, t[:, : self.n_keep, :].reshape(B, -1)), dim=1)
            for c, t in zip(context_f1, fuser1)
        )
        ms_f2 = tuple(
            torch.cat((c, t[:, : self.n_keep, :].reshape(B, -1)), dim=1)
            for c, t in zip(context_f2, fuser2)
        )
        ms_z1, ms_p1 = self._heads(self.inter_projector, self.inter_predictor, ms_f1)
        ms_z2, ms_p2 = self._heads(self.inter_projector, self.inter_predictor, ms_f2)

        def sg(zs):
            return tuple(z.detach() for z in zs)

        return {
            "context": (context_p1, context_p2, sg(context_z1), sg(context_z2)),
            "target": (target_p1, target_p2, sg(target_z1), sg(target_z2)),
            "fuser": (ms_p1, ms_p2, sg(ms_z1), sg(ms_z2)),
        }


def build_msfwsi(generator: torch.Generator, device="cpu", **kwargs) -> MSFWSI:
    """An :class:`MSFWSI` initialized from ``generator`` (a CPU generator:
    the weights are drawn on the CPU, so a seed gives the same model on
    every device) and moved to ``device``. No other random draw is made."""
    with torch.device("meta"):
        model = MSFWSI(**kwargs)
    model = torch_style_init(model.to_empty(device="cpu"), generator)
    return model.to(device)
