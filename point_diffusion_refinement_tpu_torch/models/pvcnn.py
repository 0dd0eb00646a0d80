"""PVCNN2 point-voxel backbone: the ``network_type: "pvd"`` denoiser.

Counterpart of the JAX package's ``models/pvcnn.py``.  Point features are
channels-last (B, N, C) and voxel grids (B, r, r, r, C); a ``nn.Conv3d``
reads a grid as the (B, C, r, r, r) view of the same memory (PyTorch's
channels-last 3-D layout), so no voxel axis is transposed.  Set abstraction
runs the port's idx-only FPS (kernel #6) and ball query (#3) over the
joined x_t + condition cloud, feature propagation its 3-NN (#4, k = 3); the
voxel transfers are ``ops/voxelize.py``.

Submodules carry the Flax scope names, numbered in creation order across
the whole forward as Flax numbers compact submodules (``PVConv_0..n`` over
both ladders, ``PVPointNetSA_i``, ``PVPointNetFP_i``, ``Dense_0..2``,
``VoxelAttention_0``, ``PVSharedMLP_0``), so a ``state_dict`` key is the Flax
parameter path.  The quirks of the reference trunk are kept as the JAX
package keeps them: only SA stage 0 keeps all of its PVConv blocks, voxel
attention sits on stage 1, FP convolutions never get attention, and the
last FP skip takes only the raw extra channels.

Dropout follows the ``deterministic`` argument (default True), never
``self.training``: the training steps pass no dropout draw, so dropout stays
off in training as it does in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.schedule import calc_t_emb
from ..ops.interpolate import inverse_distance_weights, three_interpolate, three_nn
from ..ops.neighbors import ball_query
from ..ops.sampling import furthest_point_sample, gather_points, group_points
from ..ops.voxelize import avg_voxelize, normalize_coords, trilinear_devoxelize, voxel_index
from .common import Dense, GroupNorm, lecun_normal_, swish

DEFAULT_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 3, 16), (256, 0.2, 32, (64, 128))),
    ((128, 3, 8), (64, 0.4, 32, (128, 256))),
    (None, (16, 0.8, 32, (256, 256, 512))),
)
DEFAULT_FP_BLOCKS = (
    ((256, 256), (256, 3, 8)),
    ((256, 256), (256, 3, 8)),
    ((256, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 2, 32)),
)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Dense and Conv kernel of ``module`` as Flax initialises
    them (lecun normal, zero bias) from ``generator``, in module order."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Conv3d):
            lecun_normal_(m.weight, m.in_channels * math.prod(m.kernel_size), generator)
            with torch.no_grad():
                m.bias.zero_()


def _dropout(x, p: Optional[float], deterministic: bool):
    return x if (deterministic or not p) else F.dropout(x, p, training=True)


def _to_grid(h: torch.Tensor) -> torch.Tensor:
    """(B, r, r, r, C) -> the (B, C, r, r, r) view ``nn.Conv3d`` reads."""
    return h.permute(0, 4, 1, 2, 3)


def _from_grid(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 4, 1)


class PVSharedMLP(nn.Module):
    """Dense + GroupNorm(8, eps 1e-5) + swish a layer."""

    def __init__(self, in_features: int, out_channels: Sequence[int]):
        super().__init__()
        self.n = len(out_channels)
        width = int(in_features)
        for i, oc in enumerate(out_channels):
            setattr(self, f"Dense_{i}", Dense(width, oc))
            setattr(self, f"GroupNorm_{i}", GroupNorm(oc, 8, epsilon=1e-5))
            width = int(oc)
        self.out_features = width

    def forward(self, x):
        for i in range(self.n):
            x = swish(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return x


class VoxelAttention(nn.Module):
    """Self-attention over the flattened positions of (B, *spatial, C), with
    float32 scores and no 1/sqrt(d) scale, a residual, then GroupNorm and
    swish."""

    def __init__(self, channels: int, num_groups: int = 8):
        super().__init__()
        for i in range(4):  # q, k, v, out
            setattr(self, f"Dense_{i}", Dense(channels, channels))
        self.GroupNorm_0 = GroupNorm(channels, num_groups, epsilon=1e-5)

    def forward(self, x):
        shape = x.shape
        B, C = shape[0], shape[-1]
        h = x.reshape(B, -1, C)
        q, k, v = self.Dense_0(h), self.Dense_1(h), self.Dense_2(h)
        w = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
        h = self.Dense_3(torch.bmm(w, v)).reshape(shape)
        return swish(self.GroupNorm_0(h + x))


class SE3d(nn.Module):
    """Squeeze-excitation over a (B, r, r, r, C) grid."""

    def __init__(self, channels: int, reduction: int = 8, use_relu: bool = False):
        super().__init__()
        self.use_relu = use_relu
        self.Dense_0 = Dense(channels, channels // reduction, use_bias=False)
        self.Dense_1 = Dense(channels // reduction, channels, use_bias=False)

    def forward(self, x):
        s = self.Dense_0(x.mean(dim=(1, 2, 3)))
        s = torch.relu(s) if self.use_relu else swish(s)
        s = torch.sigmoid(self.Dense_1(s))
        return x * s[:, None, None, None, :]


class PVConv(nn.Module):
    """Point-voxel convolution: voxelize -> two 3x3x3 Conv3d + GroupNorm +
    swish (the second optionally voxel attention) [+ SE] -> devoxelize,
    plus a pointwise MLP of the point features; the two are summed."""

    def __init__(self, in_features: int, out_channels: int, resolution: int,
                 attention: bool = False, dropout: Optional[float] = 0.1,
                 with_se: bool = False, with_se_relu: bool = False):
        super().__init__()
        self.resolution = int(resolution)
        self.attention, self.with_se = attention, with_se
        self.dropout = dropout
        self.Conv_0 = nn.Conv3d(in_features, out_channels, 3, padding=1)
        self.GroupNorm_0 = GroupNorm(out_channels, 8, epsilon=1e-5)
        self.Conv_1 = nn.Conv3d(out_channels, out_channels, 3, padding=1)
        self.GroupNorm_1 = GroupNorm(out_channels, 8, epsilon=1e-5)
        if attention:
            self.VoxelAttention_0 = VoxelAttention(out_channels)
        if with_se:
            self.SE3d_0 = SE3d(out_channels, use_relu=with_se_relu)
        self.PVSharedMLP_0 = PVSharedMLP(in_features, [out_channels])

    def forward(self, features, coords, deterministic: bool = True):
        r = self.resolution
        norm_coords = normalize_coords(coords, r)
        vox = avg_voxelize(features, voxel_index(norm_coords), r)
        h = swish(self.GroupNorm_0(_from_grid(self.Conv_0(_to_grid(vox)))))
        h = _dropout(h, self.dropout, deterministic)
        h = self.GroupNorm_1(_from_grid(self.Conv_1(_to_grid(h))))
        h = self.VoxelAttention_0(h) if self.attention else swish(h)
        if self.with_se:
            h = self.SE3d_0(h)
        return trilinear_devoxelize(h, norm_coords, r) + self.PVSharedMLP_0(features)


class PVPointNetSA(nn.Module):
    """FPS + ball query + shared MLP + max-pool; the time embedding rides
    along and is max-pooled too."""

    def __init__(self, in_features: int, num_centers: int, radius: float,
                 num_neighbors: int, out_channels: Sequence[int]):
        super().__init__()
        self.num_centers, self.radius = int(num_centers), float(radius)
        self.num_neighbors = int(num_neighbors)
        self.PVSharedMLP_0 = PVSharedMLP(3 + int(in_features), out_channels)

    def forward(self, features, coords, temb):
        centers = gather_points(coords, furthest_point_sample(coords, self.num_centers))
        # the ball query grouping in the channel order [relative coords, features]
        idx, _ = ball_query(coords, centers, self.radius, self.num_neighbors)
        grouped = torch.cat([group_points(coords, idx) - centers[:, :, None, :],
                             group_points(features, idx)], dim=-1)
        new_features = self.PVSharedMLP_0(grouped).amax(dim=-2)
        return new_features, centers, group_points(temb, idx).amax(dim=-2)


class PVPointNetA(nn.Module):
    """Group-all set abstraction: one centre at the origin."""

    def __init__(self, in_features: int, out_channels: Sequence[int]):
        super().__init__()
        self.PVSharedMLP_0 = PVSharedMLP(int(in_features) + 3, out_channels)

    def forward(self, features, coords, temb):
        h = self.PVSharedMLP_0(torch.cat([features, coords], dim=-1)[:, :, None, :])
        centers = coords.new_zeros(coords.shape[0], 1, 3)
        return h[:, :, 0, :].amax(dim=1, keepdim=True), centers, temb.amax(dim=1, keepdim=True)


class PVPointNetFP(nn.Module):
    """3-NN inverse-distance feature propagation of the features and of the
    time embedding."""

    def __init__(self, in_features: int, out_channels: Sequence[int]):
        super().__init__()
        self.PVSharedMLP_0 = PVSharedMLP(in_features, out_channels)

    def forward(self, points_coords, centers_coords, centers_features, points_features, temb):
        dist, idx = three_nn(points_coords, centers_coords)
        w = inverse_distance_weights(dist)
        interp = three_interpolate(centers_features, idx, w)
        interp_temb = three_interpolate(temb, idx, w)
        if points_features is not None:
            interp = torch.cat([interp, points_features], dim=-1)
        h = self.PVSharedMLP_0(interp[:, :, None, :])[:, :, 0, :]
        return h, points_coords, interp_temb


class PVCNN2Base(nn.Module):
    """The PVD denoiser trunk at the published completion widths by
    default.  Input widths follow from the configuration: the cloud has
    3 + ``extra_feature_channels`` channels."""

    def __init__(self, num_classes: int = 3, sv_points: int = 2048, embed_dim: int = 64,
                 use_att: bool = True, dropout: Optional[float] = 0.1,
                 extra_feature_channels: int = 0, sa_blocks: Tuple = DEFAULT_SA_BLOCKS,
                 fp_blocks: Tuple = DEFAULT_FP_BLOCKS):
        super().__init__()
        self.num_classes, self.sv_points = int(num_classes), int(sv_points)
        self.embed_dim, self.use_att, self.dropout = int(embed_dim), bool(use_att), dropout
        E = self.embed_dim
        self.Dense_0 = Dense(E, E)
        self.Dense_1 = Dense(E, E)

        counters = {}

        def add(kind: str, mod: nn.Module) -> str:
            name = f"{kind}_{counters.get(kind, 0)}"
            counters[kind] = counters.get(kind, 0) + 1
            self.add_module(name, mod)
            return name

        width = 3 + int(extra_feature_channels)
        stage_widths = []  # feature width entering each SA stage
        self.sa_stages = []  # (PVConv names, SA module name)
        for i, (conv_cfg, sa_cfg) in enumerate(sa_blocks):
            stage_widths.append(width)
            h_w = width if i == 0 else width + E
            convs = []
            if conv_cfg is not None:
                out_ch, num_blocks, vres = conv_cfg
                for p in range(num_blocks if i == 0 else 1):  # reference quirk
                    attention = (i + 1) % 2 == 0 and i > 0 and self.use_att and p == 0
                    convs.append(add("PVConv", PVConv(
                        h_w, out_ch, vres, attention=attention, dropout=dropout,
                        with_se=not attention, with_se_relu=True)))
                    h_w = int(out_ch)
            num_centers, radius, num_neighbors, out_channels = sa_cfg
            if num_centers is None:
                sa = add("PVPointNetA", PVPointNetA(h_w, out_channels))
            else:
                sa = add("PVPointNetSA", PVPointNetSA(
                    h_w, num_centers, radius, num_neighbors, out_channels))
            self.sa_stages.append((convs, sa))
            width = int(out_channels[-1])

        # only the raw extra channels feed the last FP skip
        stage_widths[0] = int(extra_feature_channels)
        if self.use_att:
            self.VoxelAttention_0 = VoxelAttention(width)
        self.fp_stages = []
        for fp_idx, (fp_cfg, conv_cfg) in enumerate(fp_blocks):
            fp = add("PVPointNetFP", PVPointNetFP(
                width + E + stage_widths[-1 - fp_idx], fp_cfg))
            width = int(fp_cfg[-1])
            convs = []
            if conv_cfg is not None:
                out_ch, num_blocks, vres = conv_cfg
                for _ in range(num_blocks):
                    convs.append(add("PVConv", PVConv(
                        width, out_ch, vres, attention=False, dropout=dropout,
                        with_se=True, with_se_relu=True)))
                    width = int(out_ch)
            self.fp_stages.append((fp, convs))
        self.PVSharedMLP_0 = PVSharedMLP(width, [128])
        self.Dense_2 = Dense(128, self.num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator)

    def forward(self, x, ts, deterministic: bool = True):
        """x (B, N, 3 + extra) channels-last; ts (B,) float timesteps ->
        (B, N, num_classes)."""
        B, N = x.shape[0], x.shape[1]
        coords, features = x[..., :3], x
        temb = self.Dense_0(calc_t_emb(ts, self.embed_dim))
        temb = self.Dense_1(F.leaky_relu(temb, negative_slope=0.1))
        temb = temb[:, None, :].expand(B, N, self.embed_dim)

        coords_list, feats_list = [], []
        for i, (convs, sa) in enumerate(self.sa_stages):
            feats_list.append(features)
            coords_list.append(coords)
            h = features if i == 0 else torch.cat([features, temb], dim=-1)
            for name in convs:
                h = getattr(self, name)(h, coords, deterministic=deterministic)
            features, coords, temb = getattr(self, sa)(h, coords, temb)

        feats_list[0] = x[..., 3:] if x.shape[-1] > 3 else None
        if self.use_att:
            features = self.VoxelAttention_0(features)
        for fp_idx, (fp, convs) in enumerate(self.fp_stages):
            features, coords, temb = getattr(self, fp)(
                coords_list[-1 - fp_idx], coords, torch.cat([features, temb], dim=-1),
                feats_list[-1 - fp_idx], temb)
            for name in convs:
                features = getattr(self, name)(features, coords, deterministic=deterministic)

        h = self.PVSharedMLP_0(features[:, :, None, :])[:, :, 0, :]
        h = _dropout(h, 0.5, deterministic)
        return self.Dense_2(h)


class PVCNN2Completion(PVCNN2Base):
    """Completion wrapper: join [x_t, condition xyz] along the point axis,
    denoise the joined cloud, return the x_t rows."""

    def forward(self, pointcloud, condition=None, ts=None, label=None,
                deterministic: bool = True):
        if condition is None:
            return super().forward(pointcloud, ts, deterministic)
        n1 = pointcloud.shape[1]
        merged = torch.cat([pointcloud, condition[..., :3].to(pointcloud.dtype)], dim=1)
        if ts is None:
            ts = pointcloud.new_zeros(pointcloud.shape[0], dtype=torch.float32)
        return super().forward(merged, ts, deterministic)[:, :n1, :]
