"""The flagship model: dual-path conditional PointNet++ denoiser.

Counterpart of the JAX package's ``models/condition_net.py``.  Two PointNet++
ladders process the noisy cloud x_t and the condition (partial) cloud;
per-level Feature Transfer (FT) modules inject condition features into the
x_t branch at both encoder and decoder; a two-stage PointNet global feature
and a class embedding condition every MLP block.  The condition branch runs
once per batch in ``encode_condition``; ``denoise`` runs the x_t branch on
its output at every reverse step.

Submodule names follow the Flax scopes (``sa_0``, ``sa_cond_1``,
``fp_2``, ``enc_map_0``, ``dec_map_4``, ``global_pnet``, ``class_emb``,
``fc_t1``, ``head_mid``...), so ``utils/weights.py`` maps a Flax parameter
tree onto ``state_dict`` by joining paths.

Routing of the fused ball-group kernel (``denoise(fused=True)``, as the
sampler calls it): under bf16 compute, the encoder/decoder FT pair of every
level whose condition support has >= 1024 points shares one launch that
gathers both tables, and the x_t SA grouping of levels with >= 1024 points
takes it too (``SetAbstraction.fused_eligible``).  Every other radius
grouping goes through the ball-query kernel, and every kNN feature
propagation through the kNN kernel.

The training forward (``forward``) is unfused by default, as in the JAX
package.  Its two opt-in routes are keyword arguments threaded through
``forward``/``encode_condition``/``denoise``: ``fused_sa`` (the
differentiable fused ball group at the eligible set-abstraction levels) and
``fused_gather`` (ball query + gather in one kernel at every other radius
grouping); see ``models/modules.py``.

``denoise`` has three more opt-in routes, for inference only and off by
default: ``fused_attention`` (the three-sweep attention-pool kernel at every
attention site of the x_t branch), ``fused_knn`` (kNN + gather in one kernel
at the eligible kNN feature propagations) and ``packed`` (merged first-layer
products).  As in the JAX package they take effect only together with the
fused inference routing (``fused=True`` with at least one eligible FT level)
and never in ``encode_condition`` or ``forward``.

Spans (``utils/profiling.py``): ``forward`` and ``denoise`` run in
``pdr.net.forward`` and ``pdr.net.denoise``; inside, the groupings, the MLP
blocks (with the embeddings and the head) and the attention pools run in
``pdr.net.group``, ``pdr.net.mlp`` and ``pdr.net.attention``.

``concate_partial_with_noisy_input`` (local and global features off) runs
one ``denoise`` over the joined cloud of [x_t, 0] and [condition, 1] rows
and returns the x_t rows.  ``record_neighbor_stats`` builds every grouping
module to record its neighbour counts inside
``modules.collect_neighbor_stats``.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from ..diffusion.schedule import calc_t_emb
from ..ops.ball_group import ball_group
from ..ops.sampling import gather_points
from ..utils import profiling
from ..utils.device import DeviceLike, resolve_device
from .common import ACTIVATIONS, Dense, GroupNorm, swish
from .model_config import (
    as_config,
    attention_kwargs,
    compute_dtype,
    global_attention_kwargs,
)
from .modules import (
    FUSED_MIN_SUPPORT,
    FUSED_QUERY_MULTIPLE,
    FeaturePropagation,
    FeatureTransfer,
    KnnFeaturePropagation,
    SetAbstraction,
)
from .pnet import Pnet2Stage


class CondFeatures(NamedTuple):
    """Loop-invariant condition-branch activations."""

    l_uvw: tuple  # positions at each level, len = n_levels + 1
    encoder_feats: tuple  # condition features after the encoder
    decoder_feats: tuple  # condition features after the decoder FP ladder
    global_feature: Optional[torch.Tensor]  # (B, G)


def _nerf_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """NeRF positional encoding, include_input=False, log-sampled."""
    parts = []
    for i in range(multires):
        f = float(2.0 ** i)
        parts.append(torch.sin(x * f))
        parts.append(torch.cos(x * f))
    return torch.cat(parts, dim=-1)


class Embed(nn.Module):
    """``nn.Embed``: a (num, features) table looked up by integer labels.
    The lookup is a ``gather_points`` row gather, so on the card its
    gradient (labels repeat in a batch) sums in a fixed order."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num_embeddings, features) / features ** 0.5)

    @profiling.spanned("pdr.net.mlp", device=True)
    def forward(self, ids):
        rows = gather_points(self.embedding[None], ids.reshape(1, -1))[0]
        return rows.reshape(*ids.shape, self.embedding.shape[1])


class PointNet2CloudCondition(nn.Module):
    """Built from the reference ``pointnet_config`` dict (the schema of
    exp_configs/mvp_configs/*.json after list restoration)."""

    def __init__(self, pointnet_config: Mapping[str, Any]):
        super().__init__()
        hp = as_config(pointnet_config)
        self.hp = hp
        self.include_t = bool(hp["include_t"])
        self.t_dim = int(hp["t_dim"])
        self.include_class_condition = bool(hp.get("include_class_condition", False))
        self.include_local_feature = bool(hp.get("include_local_feature", True))
        self.include_global_feature = bool(hp.get("include_global_feature", False))
        # one cloud of [x_t, 0] and [condition, 1] rows through the x_t
        # branch, with no condition branch
        self.concat_partial = bool(hp.get("concate_partial_with_noisy_input", False))
        if self.concat_partial:
            assert not self.include_local_feature and not self.include_global_feature
        self._record = bool(hp.get("record_neighbor_stats", False))
        self.attach_position = bool(hp["attach_position_to_input_feature"])
        self.pooling = hp.get("pooling", "max")
        self.activation_name = hp.get("activation", "relu")
        self.use_position_encoding = bool(hp.get("use_position_encoding", False))
        self.pos_multires = int(hp.get("position_encoding_multires", 10))
        self.dtype = compute_dtype(hp)
        dtype = self.dtype

        att = hp.get("attention_setting", None)
        g_att = hp.get("global_attention_setting", None)  # x_t branch only

        pos_w = (6 * self.pos_multires if self.use_position_encoding else 0) + (
            3 if self.attach_position else 0
        )
        # the joined cloud's extra channel is the flag
        x_feat0 = (1 if self.concat_partial else int(hp.get("in_fea_dim", 0))) + pos_w
        c_feat0 = int(hp.get("partial_in_fea_dim", 0)) + pos_w

        t_w = 4 * self.t_dim
        class_w = int(hp.get("class_condition_dim", 0))
        if self.include_class_condition:
            self.class_emb = Embed(int(hp["num_class"]), class_w)
        if self.include_t:
            self.fc_t1 = Dense(self.t_dim, t_w)
            self.fc_t2 = Dense(t_w, t_w)

        global_w = 0
        if self.include_global_feature:
            pnet_arch = hp["pnet_global_feature_architecture"]
            self.global_pnet = Pnet2Stage(
                3 + int(hp.get("partial_in_fea_dim", 0)), pnet_arch[0], pnet_arch[1],
                bn=bool(hp.get("bn", True)),
                remove_last_activation=bool(
                    hp.get("global_feature_remove_last_activation", True)
                ),
                dtype=dtype,
            )
            global_w = self.global_pnet.out_features

        arch = hp["architecture"]
        n = len(arch["npoint"])
        self.n_levels = n
        fd = list(arch["feature_dim"])
        dfd = list(arch["decoder_feature_dim"])
        x_feat_w = [x_feat0] + fd[1:n + 1]  # x_t features at each level

        if self.include_local_feature:
            mapper = hp["feature_mapper_architecture"]
            cond_arch = hp["condition_net_architecture"]
            cfd = list(cond_arch["feature_dim"])
            cdfd = list(cond_arch["decoder_feature_dim"])
            c_feat_w = [c_feat0] + cfd[1:n + 1]
            c_dec_w = cdfd[:n] + [cfd[n]]  # condition decoder features per level
            self.sa_cond = self._add_ladder("sa_cond", self._sa_ladder(
                cond_arch, c_feat_w, False, 0, 0, att))
            self.fp_cond = self._add_ladder("fp_cond", self._fp_ladder(
                cond_arch, c_feat_w, [c_dec_w[j + 1] for j in range(n)], False, 0, 0, att))
            enc_dims = list(mapper["encoder_feature_map_dim"])
            dec_dims = list(mapper["decoder_feature_map_dim"])
            self.enc_map = self._add_ladder("enc_map", self._ft_modules(
                mapper, enc_dims, int(mapper["encoder_mlp_depth"]),
                mapper["encoder_radius"], mapper["encoder_nsample"], True,
                c_feat_w, x_feat_w))
            dec_query_w = dfd[:n] + [fd[n]]
            self.dec_map = self._add_ladder("dec_map", self._ft_modules(
                mapper, dec_dims, int(mapper["decoder_mlp_depth"]),
                mapper["decoder_radius"], mapper["decoder_nsample"], False,
                c_dec_w, dec_query_w))
            sa_in = [enc_dims[i] + x_feat_w[i] for i in range(n)]
            fp_known = [dec_dims[j + 1] + dec_query_w[j + 1] for j in range(n)]
            head_in = dec_dims[0] + dfd[0] + 3
        else:
            sa_in = x_feat_w[:n]
            fp_known = [fd[n] if j + 1 == n else dfd[j + 1] for j in range(n)]
            head_in = dfd[0] + 3

        if self.include_global_feature:
            cond = (True, global_w, self.include_class_condition, class_w)
        else:
            cond = (self.include_class_condition, class_w, False, 0)
        self.sa = self._add_ladder("sa", self._sa_ladder(
            arch, sa_in, self.include_t, t_w, cond, att, g_att))
        self.fp = self._add_ladder("fp", self._fp_ladder(
            arch, x_feat_w, fp_known, self.include_t, t_w, cond, att, g_att))

        out_dim = int(hp["out_dim"])
        puf = int(hp.get("point_upsample_factor", 1))
        if puf > 1:
            if bool(hp.get("include_displacement_center_to_final_output", False)):
                puf = puf - 1
            out_dim = out_dim * (puf + 1)
        self.out_dim = out_dim
        self.head_bn_first = bool(hp["bn_first"])
        self.head_bn = bool(hp.get("bn", True))
        if self.head_bn_first:
            self.head_out = Dense(head_in, out_dim)
        else:
            self.head_mid = Dense(head_in, 128, use_bias=bool(hp["bias"]), dtype=dtype)
            if self.head_bn:
                self.head_norm = GroupNorm(128, 32, epsilon=1e-5)
            self.head_out = Dense(128, out_dim)

    # ---- construction helpers ------------------------------------------
    def _add_ladder(self, name: str, mods: Sequence[nn.Module]) -> list:
        for i, m in enumerate(mods):
            self.add_module(f"{name}_{i}", m)
        return list(mods)

    def _common(self):
        hp = self.hp
        return dict(
            bn=bool(hp.get("bn", True)), bn_first=bool(hp["bn_first"]),
            bias=bool(hp["bias"]), res_connect=bool(hp["res_connect"]),
            activation=hp.get("activation", "relu"), dtype=self.dtype,
            record_neighbor_stats=self._record,
        )

    def _cond_kwargs(self, cond):
        if not cond:
            return dict(include_condition=False, include_second_condition=False)
        inc, w, inc2, w2 = cond
        return dict(include_condition=inc, condition_features=w,
                    include_second_condition=inc2, second_condition_features=w2)

    def _sa_ladder(self, arch, in_w, include_t, t_w, cond, att, g_att=None):
        hp = self.hp
        nd = arch["neighbor_definition"]
        nd = tuple(nd) if isinstance(nd, (list, tuple)) else (nd,) * len(arch["radius"])
        fd, depth = arch["feature_dim"], int(arch["mlp_depth"])
        mods = []
        for i in range(len(arch["npoint"])):
            spec = [fd[i]] * depth + [fd[i + 1]]
            mods.append(SetAbstraction(
                in_w[i], int(arch["npoint"][i]), float(arch["radius"][i]),
                int(arch["nsample"][i]), tuple(spec[1:]), include_t=include_t,
                t_features=t_w, use_xyz=bool(hp["model.use_xyz"]),
                include_abs_coordinate=bool(hp["include_abs_coordinate"]),
                include_center_coordinate=bool(hp.get("include_center_coordinate", False)),
                first_conv_features=(spec[0] if bool(hp["bn_first"]) and i == 0 else None),
                neighbor_def=nd[i], **self._cond_kwargs(cond), **self._common(),
                **attention_kwargs(att), **global_attention_kwargs(g_att, i),
            ))
        return mods

    def _fp_ladder(self, arch, unknown_w, known_w, include_t, t_w, cond, att, g_att=None):
        hp = self.hp
        dfd = arch["decoder_feature_dim"]
        depth = int(arch["decoder_mlp_depth"])
        use_knn = bool(arch.get("use_knn_FP", False))
        K = int(arch.get("K", 3))
        nd = arch["neighbor_definition"]
        nd = tuple(nd) if isinstance(nd, (list, tuple)) else (nd,) * len(arch["radius"])
        mods = []
        for j in range(len(dfd) - 1):
            # the grouper of FP j groups at SA level j's radius and nsample
            kw = dict(include_t=include_t, t_features=t_w,
                      include_grouper=bool(arch.get("include_grouper", False)),
                      radius=float(arch["radius"][j]), nsample=int(arch["nsample"][j]),
                      use_xyz=bool(hp["model.use_xyz"]),
                      include_abs_coordinate=bool(hp["include_abs_coordinate"]),
                      include_center_coordinate=bool(
                          hp.get("include_center_coordinate", False)),
                      neighbor_def=nd[j], **self._common())
            if use_knn:
                # the global condition feeds mlp2, the class condition mlp1
                ck = self._cond_kwargs(cond)
                mods.append(KnnFeaturePropagation(
                    unknown_w[j], known_w[j], (dfd[j],) * depth, (dfd[j],) * depth, K,
                    **ck, **kw, **attention_kwargs(att), **global_attention_kwargs(g_att, j)))
            else:
                mods.append(FeaturePropagation(
                    unknown_w[j], known_w[j], (dfd[j],) * depth,
                    **self._cond_kwargs(cond), **kw))
        return mods

    def _ft_modules(self, mapper, dims, depth, radii, nsamples, first_conv_in_first,
                    support_w, query_w):
        hp = self.hp
        fm_att = None
        att = hp.get("attention_setting", None)
        if att is not None:
            fm_att = dict(att)
            fm_att["use_attention_module"] = bool(
                att.get("add_attention_to_FeatureMapper_module", False)
            )
        mods = []
        for i in range(len(dims)):
            fc = None
            if i == 0 and first_conv_in_first and bool(hp["bn_first"]):
                fc = int(dims[i])
            mods.append(FeatureTransfer(
                support_w[i], query_w[i], (dims[i],) * depth, float(radii[i]),
                int(nsamples[i]), use_xyz=bool(hp["model.use_xyz"]),
                include_abs_coordinate=bool(hp["include_abs_coordinate"]),
                include_center_coordinate=bool(hp.get("include_center_coordinate", False)),
                first_conv_features=fc, neighbor_def=mapper["neighbor_definition"],
                **self._common(), **attention_kwargs(fm_att),
            ))
        return mods

    def init_weights(self, generator: torch.Generator) -> None:
        """Re-draw every Dense kernel (lecun normal, zero bias) and embedding
        from ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, Embed):
                with torch.no_grad():
                    f = m.embedding.shape[1]
                    m.embedding.normal_(0.0, f ** -0.5, generator=generator)

    @classmethod
    def from_config(cls, pointnet_config: Mapping[str, Any], device: DeviceLike = None,
                    seed: Optional[int] = 0) -> "PointNet2CloudCondition":
        """Build on ``device`` (``cuda`` unless ``"cpu"`` is asked for), with
        weights drawn from ``seed`` when it is not None."""
        dev = resolve_device(device)
        model = cls(pointnet_config)
        if seed is not None:
            g = torch.Generator()
            g.manual_seed(int(seed))
            model.init_weights(g)
        return model.to(dev).eval()

    # ---- pieces -----------------------------------------------------------
    @profiling.spanned("pdr.net.mlp", device=True)
    def _head(self, h):
        act = ACTIVATIONS[self.activation_name]
        if self.head_bn_first:
            return self.head_out(act(h))
        h = self.head_mid(h)
        if self.head_bn:
            h = self.head_norm(h)
        return self.head_out(act(h))

    @profiling.spanned("pdr.net.mlp", device=True)
    def _t_embedding(self, ts):
        t_emb = calc_t_emb(ts, self.t_dim)
        return swish(self.fc_t2(swish(self.fc_t1(t_emb))))

    def _split(self, pointcloud):
        """attach_position + break-up: (xyz, features = [extra..., pe?, xyz])."""
        xyz = pointcloud[..., 0:3]
        parts = [pointcloud[..., 3:]]
        if self.use_position_encoding:
            parts.append(_nerf_encode(xyz, self.pos_multires))
        if self.attach_position:
            parts.append(xyz)
        features = torch.cat(parts, dim=-1)
        if features.shape[-1] == 0:
            features = None
        return xyz, features

    def _cat(self, parts):
        # bf16 compute: every consumer promotes to bf16 anyway, so the parts
        # are cast first (identical values, half the bytes)
        if self.dtype is not None:
            parts = [p.to(self.dtype) for p in parts]
        return torch.cat(parts, dim=-1)

    def _ft_fused_levels(self, cond: CondFeatures) -> set:
        """Levels whose encoder/decoder FT pair may share one fused launch:
        bf16 compute, matching geometry and channel layout, and a condition
        support of >= 1024 points."""
        if not self.include_local_feature or self.dtype is None:
            return set()
        levels = set()
        for i, (enc, dec) in enumerate(zip(self.enc_map, self.dec_map)):
            if (
                enc.neighbor_def == "radius" and dec.neighbor_def == "radius"
                and enc.radius == dec.radius and enc.k == dec.k
                and enc.use_xyz and dec.use_xyz and enc.include_abs and dec.include_abs
                and enc.include_center == dec.include_center
                and cond.encoder_feats[i] is not None and cond.decoder_feats[i] is not None
                and cond.l_uvw[i].shape[1] >= FUSED_MIN_SUPPORT
            ):
                levels.add(i)
        return levels

    # ---- the two halves -------------------------------------------------
    def encode_condition(self, condition: torch.Tensor, fused_gather: bool = False,
                         fused_sa: bool = False) -> CondFeatures:
        """Run the condition branch (SA + FP ladders + global PointNet) once.
        condition: (B, M, 3 + partial_extra), e.g. (B, 3072, 4)."""
        uvw, cond_features = self._split(condition)
        global_feature = None
        if self.include_global_feature:
            global_input = torch.cat([uvw, condition[..., 3:]], dim=-1)
            global_feature = self.global_pnet(global_input)
        l_uvw, l_feats = [uvw], [cond_features]
        if self.include_local_feature:
            for i, sa in enumerate(self.sa_cond):
                ui, fi = sa(l_uvw[i], l_feats[i], pooling=self.pooling, fps_ordered=i > 0,
                            fused_gather=fused_gather, fused_sa=fused_sa)
                l_uvw.append(ui)
                l_feats.append(fi)
            encoder_feats = tuple(l_feats)
            feats = list(l_feats)
            n = len(self.fp_cond)
            for i in range(-1, -(n + 1), -1):
                feats[i - 1] = self.fp_cond[i](
                    l_uvw[i - 1], l_uvw[i], feats[i - 1], feats[i], pooling=self.pooling,
                    fused_gather=fused_gather,
                )
            decoder_feats = tuple(feats)
        else:
            encoder_feats = decoder_feats = tuple(l_feats)
        return CondFeatures(tuple(l_uvw), encoder_feats, decoder_feats, global_feature)

    @profiling.spanned("pdr.net.denoise", device=True)
    def denoise(self, pointcloud, ts=None, label=None, cond: Optional[CondFeatures] = None,
                fused: bool = False, fused_gather: bool = False, fused_sa: bool = False,
                fused_attention: bool = False, fused_knn: bool = False,
                packed: bool = False):
        """The x_t branch given precomputed condition features.

        pointcloud (B, N, 3); ts (B,) float; label (B,) int -> (B, N, out_dim).
        ``fused=True`` (inference) routes the eligible groupings through the
        fused ball-group kernel; ``fused_attention``, ``fused_knn`` and
        ``packed`` are inference routes on top of it; ``fused_gather`` and
        ``fused_sa`` are the training step's routes."""
        xyz, features = self._split(pointcloud)
        t_emb = self._t_embedding(ts) if (ts is not None and self.include_t) else None
        class_emb = None
        if label is not None and self.include_class_condition:
            class_emb = self.class_emb(label)
        if self.include_global_feature:
            condition_emb = cond.global_feature
            second_condition_emb = class_emb if self.include_class_condition else None
        else:
            condition_emb = class_emb if self.include_class_condition else None
            second_condition_emb = None

        ft_levels = self._ft_fused_levels(cond) if (fused and cond is not None) else set()
        fused = bool(ft_levels)
        # the inference routes ride on the fused inference routing
        inference = dict(fused_attention=fused and fused_attention, packed=fused and packed)
        dec_groups = {}  # level -> (grouped, counts) for the decoder FT

        def enc_group(i, q_xyz):
            if i not in ft_levels or q_xyz.shape[1] % FUSED_QUERY_MULTIPLE != 0:
                return None
            enc = self.enc_map[i]
            with profiling.span("pdr.net.group", device=True):
                (g_enc, g_dec), counts = ball_group(
                    cond.l_uvw[i], [cond.encoder_feats[i], cond.decoder_feats[i]], q_xyz,
                    enc.radius, enc.k, include_center=enc.include_center,
                    empty_mode="center_zero",
                )
            dec_groups[i] = (g_dec, counts)
            return g_enc, counts

        kw = dict(t_emb=t_emb, condition_emb=condition_emb,
                  second_condition_emb=second_condition_emb, pooling=self.pooling)
        l_xyz, l_features = [xyz], [features]
        for i, sa in enumerate(self.sa):
            if self.include_local_feature:
                mapped = self.enc_map[i](
                    cond.l_uvw[i], cond.encoder_feats[i], l_xyz[i],
                    query_feats=l_features[i], subset=False, pooling=self.pooling,
                    pregrouped=enc_group(i, l_xyz[i]), fused_gather=fused_gather,
                    **inference,
                )
                input_feature = self._cat([mapped, l_features[i]])
            else:
                input_feature = l_features[i]
            xi, fi = sa(l_xyz[i], input_feature, fused=fused, fps_ordered=i > 0,
                        fused_gather=fused_gather, fused_sa=fused_sa, **inference, **kw)
            l_xyz.append(xi)
            l_features.append(fi)

        n = len(self.fp)
        for i in range(-1, -(n + 1), -1):
            if self.include_local_feature:
                lvl = len(l_xyz) + i
                mapped = self.dec_map[i](
                    cond.l_uvw[i], cond.decoder_feats[i], l_xyz[i],
                    query_feats=l_features[i], subset=False, pooling=self.pooling,
                    pregrouped=dec_groups.get(lvl), fused_gather=fused_gather,
                    **inference,
                )
                input_feature = self._cat([mapped, l_features[i]])
            else:
                input_feature = l_features[i]
            fp_kw = dict(fused_gather=fused_gather)
            if isinstance(self.fp[i], KnnFeaturePropagation):
                fp_kw.update(fused_knn=fused and fused_knn, **inference)
            l_features[i - 1] = self.fp[i](
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], input_feature, **fp_kw, **kw
            )

        if self.include_local_feature:
            mapped = self.dec_map[0](
                cond.l_uvw[0], cond.decoder_feats[0], l_xyz[0],
                query_feats=l_features[0], subset=False, pooling=self.pooling,
                pregrouped=dec_groups.get(0), fused_gather=fused_gather, **inference,
            )
            out_feature = self._cat([mapped, l_features[0]])
        else:
            out_feature = l_features[0]
        return self._head(self._cat([out_feature, xyz]))

    @profiling.spanned("pdr.net.forward", device=True)
    def forward(self, pointcloud, condition=None, ts=None, label=None,
                fused_gather: bool = False, fused_sa: bool = False):
        """Training-path forward = encode_condition + denoise, unfused unless
        a training route is asked for."""
        if self.include_global_feature or self.include_local_feature:
            assert condition is not None
        routes = dict(fused_gather=fused_gather, fused_sa=fused_sa)
        if self.concat_partial:
            B1, N1, C1 = pointcloud.shape
            assert C1 == 3
            pc = torch.cat([pointcloud, pointcloud.new_zeros(B1, N1, 1)], dim=2)
            cnd = condition.to(pointcloud.dtype)
            if cnd.shape[-1] == 3:
                cnd = torch.cat([cnd, cnd.new_ones(cnd.shape[:2] + (1,))], dim=2)
            out = self.denoise(torch.cat([pc, cnd], dim=1), ts=ts, label=label, cond=None,
                               **routes)
            return out[:, :N1, :]
        cond = self.encode_condition(condition, **routes) if condition is not None else None
        return self.denoise(pointcloud, ts=ts, label=label, cond=cond, **routes)
