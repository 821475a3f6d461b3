"""The fused denoiser: the whole `ConditionalPointNet2` forward as one kernel
launch, `csrc/fused_denoiser.cu` (counterpart: `slide_tpu/models/
fused_denoiser.py`, TPU kernel `_pallas_forward`, body `_forward_tile`).

Scope, as in the JAX package (`supports_config`): the architecture shared by
the shipped position-DDPM and feature-DDPM configs.  'nn' neighbourhoods with
npoint >= N (no FPS inside the forward), KnnFP decoder, attention pooling
everywhere, GroupNorm after each conv, residual MLPs, t and class injection,
and the transform_output head.

The network's weights are packed once (`pack_weights`) into one contiguous
fp32 buffer, with every dense kernel kept (in, out) as flax stores it, and an
int32 table of per-layer offsets and widths (`TABLE`, mirrored field by field
by the `Spec` struct of the CUDA source) that the kernel walks at run time:
the kp and latent nets share one compiled kernel.  The timestep embedder and
the class embedding stay outside the kernel, as in JAX.

`fused_forward_plain` is the plain PyTorch version: the forward-only form of
`_forward_tile`, with real indexing in place of the TPU kernel's one-hot
matmuls, and with its weights read through the same table the kernel reads.
It keeps the TPU kernel's order of operations where a near-tie could flip a
neighbour pick:
  - squared distances are max((|x|^2 + |y|^2) - 2<x, y>, 0), each sum and
    product a separate fp32 operation in a fixed order, no fused multiply-add
    (the kernel rounds the same way, so its kNN picks are the plain ones);
  - kNN takes the K smallest distances, ties to the lowest index (a stable
    sort; the kernel runs K rounds of masked argmin);
  - an SA level whose K equals N groups slot j = point j, in index order;
  - KnnFP channels are [features, dist, weight, abs, rel, center].
GroupNorm is the tail-passthrough form with var = E[x^2] - E[x]^2 (clipped at
0 with `torch.maximum`, as flax's GroupNorm clips it with `jnp.maximum`), eps
1e-5 inside the rsqrt.

`fused_forward` runs the plain version on a CPU tensor and the kernel on a
CUDA tensor; on the card it launches or raises.

Training (`make_fused_train_fn`) wraps the same forward in a
`torch.autograd.Function` whose backward is K2, `csrc/fused_denoiser_bwd.cu`
(counterpart: the TPU kernel `_pallas_backward`): per cloud, a chain that
recomputes the forward, keeps every activation the backward needs in a
per-cloud tape (offsets in the layer table and in K2's own, `TABLE2`) and
walks the layers in reverse, writing each product's output gradient beside
its input; then a grouped kernel that computes every weight gradient from
the tape over the whole batch (`_k2_jobs`; plain version
`weight_grads_plain`).  On the CPU the backward is autograd through
`fused_forward_plain`, recomputed inside `backward`: K2's plain version.  The clamps (distances at
0, GroupNorm variance at 0) are `torch.maximum`, whose gradient at a tie is
0.5, as `jnp.maximum`'s is; K2 follows the same rule.

Limits of both kernels (`limits_error`): N <= 32 points, at most 4 levels,
widths up to 1024 (the t / class embeddings included), at most 32
GroupNorm groups and MLPs of at most 6 layers.  A config past them is
outside the fused scope: `make_fused_net_fn` and `make_fused_train_fn`
return None for it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
from torch import nn

from slide_tpu_torch import _build
from slide_tpu_torch.models.denoiser import ConditionalPointNet2
from slide_tpu_torch.nn.layers import GroupNorm, TailGroupNorm

_EPS = 1e-5

# limits of csrc/fused_denoiser.cu (its kMax* constants)
MAX_LAYERS = 6
MAX_LEVELS = 4
MAX_POINTS = 32
MAX_VEC = 1024
MAX_GROUPS = 32
N_GRAD_BUFFERS = 6          # K2's row-sized gradient buffers
STATS = 3 * MAX_GROUPS      # a GroupNorm's tape: mean, inverse std, var before the clip
# K1's plan: blocks per cloud, weight products per forward, ring stages, and
# the dynamic shared memory a block may have on Hopper (227 KB)
K1_CLUSTER = 8
MAX_STREAM = 128
K1_STAGES = 2
K1_SMEM_BYTES = 232448
K1_SMEM_BYTES_2 = 115712    # each of two blocks on one SM (228 KB less 1 KB a block)
# K1's placements in the order its plan tries them: (blocks per SM, row
# buffers in device memory).  Two blocks per SM doubles the clusters the card
# holds at once (an H100 holds 15 clusters of 8 at one block per SM), but
# row buffers in device memory cost more than that: on an H100 the latent
# net at batch 16 takes 1.8x as long at two blocks per SM with its rows there
# as at one with them in shared memory (`chip_smoke.py`'s k1_plan lines)
K1_PLACEMENTS = ((2, (0, 0)), (1, (0, 0)), (2, (0, 1)), (2, (1, 1)), (1, (0, 1)), (1, (1, 1)))
# K2's placements (blocks per cloud, blocks per SM): 4 at 2 per SM when no
# product is wider than K2_WIDE_2 columns, else 8 at 1 (two blocks per SM
# leave a thread 112 registers, too few for wider products: they spill).  On
# an H100 at batch 32 the kp net is fastest at (4, 2) (62 clusters at once:
# one wave), the latent net at (8, 1) (15 at once: three waves, but half the
# rows a block), of the four (4|8, 1|2) (PERF.md §6)
K2_PLACEMENTS = ((4, 2), (8, 1))
K2_WIDE_2 = 256
K2_MAX_STREAM = 2 * MAX_STREAM    # the recompute's products and the backward's
# K2's weight-gradient kernel: output tiles of DW_TILE x DW_TILE (the
# kernel's kDwTile); a job's depth split in one part per DW_PART_ROWS of its
# rows per cloud, at most DW_MAX_SPLITS (a grouped layer's 256 rows: 8
# parts, a point layer's 16: 1).  On an H100 at batch 32 the kp net's
# kernel takes 0.32 ms so split and 0.61 at 4 parts of 64 rows
# (`PERF.md` §6)
DW_TILE = 128
DW_MAX_SPLITS = 8
DW_PART_ROWS = 32
# where a weight-gradient product's rows come from (`_k2_jobs`)
TAPE, FROM_T4, FROM_CLS, FROM_G = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Config support check / spec (copies of the JAX package's, same semantics)


def supports_config(config: Mapping[str, Any]) -> bool:
    """True when `config` (a pointnet_config) is inside the fused kernel's
    architecture scope (see the module docstring)."""
    try:
        arch = config["architecture"]
        ok = (
            config.get("network_type", "pointnet++") == "pointnet++"
            and config["include_t"]
            and config.get("include_class_condition", False)
            and not config.get("include_local_feature", True)
            and not config.get("include_global_feature", False)
            and not config.get("concate_partial_with_noisy_input", False)
            and config.get("transform_output", True)
            and config["attach_position_to_input_feature"]
            and not config.get("use_position_encoding", False)
            and not config["bn_first"]
            and config["bias"]
            and config["res_connect"]
            and config.get("bn", True)
            and config.get("activation", "relu") == "relu"
            and config["model.use_xyz"]
            and not config.get("record_neighbor_stats", False)
            and arch["neighbor_definition"] == "nn"
            and arch.get("use_knn_FP", False)
            and not arch.get("include_grouper", False)
            and config.get("point_upsample_factor", 1) == 1
        )
        att = config.get("attention_setting") or {}
        ok = ok and att.get("use_attention_module", False) \
            and att.get("attention_bn", False) \
            and att.get("transform_grouped_feat_out", False) \
            and att.get("last_activation", False)
        gatt = config.get("global_attention_setting")
        ok = ok and not (gatt or {}).get("use_global_attention_module", False)
        return bool(ok)
    except (KeyError, TypeError):
        return False


def build_spec(config: Mapping[str, Any], n_points: int) -> dict:
    """Static widths of the fused forward (the channel arithmetic of the
    network's SA and KnnFP stacks)."""
    if not supports_config(config):
        raise ValueError("config not supported by the fused denoiser")
    arch = config["architecture"]
    in_fea = config["in_fea_dim"] + 3          # attach_position
    inc_abs = bool(config["include_abs_coordinate"])
    inc_cen = bool(config.get("include_center_coordinate", False))
    extra = 3 * (1 + int(inc_abs) + int(inc_cen))
    fdim = list(arch["feature_dim"])
    ddim = list(arch["decoder_feature_dim"])
    mlp_depth = arch["mlp_depth"]
    dec_depth = arch["decoder_mlp_depth"]

    sa = []
    for i in range(len(arch["npoint"])):
        if arch["npoint"][i] < n_points:
            raise ValueError("fused denoiser requires npoint >= N (no FPS)")
        spec = [fdim[i]] * mlp_depth + [fdim[i + 1]]
        if i == 0:
            spec[0] = in_fea
        c_in1 = spec[0]
        spec = [spec[0] + extra] + spec[1:]
        sa.append(dict(spec=spec, c_in1=max(c_in1, 32), c_in2=max(spec[0], 32),
                       k=min(arch["nsample"][i], n_points)))

    fp = []
    for i in range(len(ddim) - 1):
        skip = in_fea if i == 0 else fdim[i]
        spec1 = [ddim[i + 1] + 11] + [ddim[i]] * dec_depth
        spec2_head = ddim[i] + skip
        c_in1 = spec2_head - spec1[-1]
        spec2 = [spec2_head + 3] + [ddim[i]] * dec_depth
        if arch["K"] > n_points:
            # the module's kNN raises for k > n; match by rejecting
            raise ValueError("fused denoiser requires FP K <= N")
        fp.append(dict(spec1=spec1, spec2=spec2, k=arch["K"],
                       c_in1=max(c_in1, 32), c_in2=max(spec1[0], 32)))

    head_in = ddim[0] + 3
    return dict(n=n_points, in_fea=in_fea, extra=(inc_abs, inc_cen),
                sa=sa, fp=fp, head_in=head_in,
                out_dim=config["out_dim"], t4=4 * config["t_dim"],
                cls=config["class_condition_dim"], fdim=fdim, ddim=ddim)


def limits_error(spec: Mapping) -> Optional[str]:
    """Which limit of the fused kernels (K1 and K2) `spec` (a `build_spec`)
    breaks, or None when it is inside them."""
    if spec["n"] > MAX_POINTS:
        return f"the fused kernels hold at most {MAX_POINTS} points, got {spec['n']}"
    if len(spec["sa"]) > MAX_LEVELS or len(spec["fp"]) > MAX_LEVELS:
        return f"the fused kernels hold at most {MAX_LEVELS} levels"
    widths = [spec["t4"], spec["cls"], spec["head_in"], 128, spec["out_dim"]]
    layers = []
    for s in spec["sa"]:
        widths += s["spec"] + [s["c_in1"] + s["c_in2"]]
        layers.append(len(s["spec"]) - 1)
    for f in spec["fp"]:
        widths += f["spec1"] + f["spec2"] + [f["c_in1"] + f["c_in2"]]
        layers += [len(f["spec1"]) - 1, len(f["spec2"]) - 1]
    if max(widths) > MAX_VEC:
        return f"the fused kernels take widths up to {MAX_VEC}, got {max(widths)}"
    if max(layers) > MAX_LAYERS:
        return f"the fused kernels take MLPs of at most {MAX_LAYERS} layers, got {max(layers)}"
    # every GroupNorm of this architecture has min(32, channels) groups
    return None


def scope_error(config: Mapping[str, Any], n_points: int) -> Optional[str]:
    """Why `config` at `n_points` points is outside the fused scope (the
    architecture, the spec's channel arithmetic or a kernel limit), or None
    when the fused kernels take it."""
    if not supports_config(config):
        return "the architecture is outside the fused denoiser's scope"
    try:
        spec = build_spec(config, n_points)
    except ValueError as e:
        return str(e)
    return limits_error(spec)


# ---------------------------------------------------------------------------
# The layer table.  A schema is a tuple of fields: (name,) is one int,
# (name, schema) a nested record, (name, schema, count) an array of them
# (schema None: of ints).  `TABLE` is the kernel's `Spec` struct, field for
# field, in order; unused slots are zeros.

_DENSE = (("w",), ("b",), ("cin",), ("cout",))   # b = -1: no bias
# c channels, g groups; p: K2's tape of the per-block sums of d scale / d bias
_NORM = (("s",), ("b",), ("c",), ("g",), ("p",))
# The fields after the weights are K2's tape: offsets into its per-cloud
# scratch of each activation the backward reads (z: a conv's output, a: after
# GroupNorm and relu, h: after the injection, st: the GroupNorm's STATS,
# out: the MLP's output after the residual; t/tn, u/un, v/vn: the attention's
# three GroupNorms' inputs and outputs, s its scores, w its softmax weights;
# x: a level's grouped rows, nf: a KnnFP level's [interp, skip, xyz]).  The
# backward writes each product's d output where its weight-gradient kernel
# reads it: over z, s, v, u and t (a GroupNorm's input, or the scores, read
# by nothing else), and into dout (d of an MLP's output), dvt / dvc (the
# per-block sums of d of the injection vectors) and df (d of the
# attention's feature product).
_MLP = (("n_layers",), ("inject_t",), ("inject_c",), ("res",),  # res 1: +x, 2: +res_conv(x)
        ("conv", _DENSE, MAX_LAYERS), ("norm", _NORM, MAX_LAYERS),
        ("fc_t", _DENSE), ("fc_c", _DENSE), ("res_conv", _DENSE),
        ("z", None, MAX_LAYERS), ("a", None, MAX_LAYERS), ("h", None, MAX_LAYERS),
        ("st", None, MAX_LAYERS), ("out",), ("dout",), ("dvt",), ("dvc",),
        ("vt",), ("vc",))                 # K1: offsets of its t and class vectors
_ATT = (("feat_conv", _DENSE), ("grouped_conv", _DENSE), ("w_norm_1", _NORM),
        ("w_conv_1", _DENSE), ("w_norm_2", _NORM), ("w_conv_2", _DENSE),
        ("out_conv", _DENSE), ("out_norm", _NORM),
        ("t",), ("tn",), ("st1",), ("u",), ("st2",), ("un",), ("s",), ("v",),
        ("st3",), ("vn",), ("w",), ("df",))
_SA = (("k",), ("mlp", _MLP), ("att", _ATT), ("x",), ("ld",))   # ld: K1's row stride
_FP = (("k",), ("mlp1", _MLP), ("att", _ATT), ("mlp2", _MLP), ("x",), ("nf",), ("ld",))
# one weight product of K1 (K2), in the order it runs them (`_k1_plan`,
# `_k2_plan`)
_STREAM = (("w",), ("cin",), ("cout",), ("bk",), ("passes",), ("mt",))
TABLE = (("n",), ("din",), ("out_dim",), ("t4",), ("cls",), ("inc_abs",),
         ("inc_cen",), ("n_sa",), ("n_fp",), ("cloud_floats",),
         # K1's plan (`_k1_plan`)
         ("pts",), ("smem_bytes",), ("occupancy",), ("blk_floats",), ("vec",), ("inj",),
         ("bars",), ("table",), ("ring",), ("stage",),
         ("buf", None, 2), ("bglob", None, 2), ("pbuf",), ("pld",), ("hld",),
         ("lvl", None, MAX_LEVELS + 1), ("lcap", None, MAX_LEVELS + 1),
         ("dist",), ("knn",), ("kmax",), ("xyz",), ("part",), ("gn",), ("red",), ("vecs",),
         ("n_stream",), ("stream", _STREAM, MAX_STREAM),
         ("sa", _SA, MAX_LEVELS), ("fp", _FP, MAX_LEVELS),
         ("head1", _DENSE), ("head_norm", _NORM), ("head_out", _DENSE))
# K2's own table (`Spec2`): its plan (`_k2_plan`: blocks per cloud and per
# SM, points per block, shared memory in floats from the block's start: the
# barriers and plan, both tables, the weight ring, the small tables), its
# per-cloud floats, the level features before the KnnFP tower, the head's
# tape, its gradient buffers and accumulators (`_tape_layout`), and its list
# of products: the recompute's, then the backward's (d input = d output x
# W^T, over the transposed weights at offset `size` + w)
TABLE2 = (("cluster",), ("occupancy",), ("pts",), ("smem_bytes",),
          ("bars",), ("table",), ("table2",), ("ring",), ("stage",),
          ("xyz",), ("dist",), ("knn",), ("kmax",), ("picks",), ("part",), ("gn",),
          ("red",), ("vecs",), ("cs",),
          ("bwd_floats",), ("flvl", None, MAX_LEVELS + 1),
          ("hin",), ("hz",), ("hst",), ("ha",),
          ("gbuf", None, N_GRAD_BUFFERS), ("gld",), ("gf", None, MAX_LEVELS + 1),
          ("gdist",), ("gxyz",), ("gvec",),
          ("n_stream",), ("stream", _STREAM, K2_MAX_STREAM))


def table_ints(schema=TABLE) -> int:
    """Number of int32 entries of a record of `schema`."""
    total = 0
    for field in schema:
        sub = field[1] if len(field) > 1 else None
        size = 1 if sub is None else table_ints(sub)
        total += size * (field[2] if len(field) > 2 else 1)
    return total


def encode_table(schema, value: Optional[Mapping]) -> list[int]:
    """Flatten `value` (nested dicts and lists; None or a missing key: zeros)
    into ints in schema order."""
    out: list[int] = []
    for field in schema:
        name, sub = field[0], (field[1] if len(field) > 1 else None)
        v = None if value is None else value.get(name)
        if len(field) > 2:
            items = list(v or [])
            if len(items) > field[2]:
                raise ValueError(f"{name}: {len(items)} entries, the kernel "
                                 f"holds {field[2]}")
            items += [None] * (field[2] - len(items))
        else:
            items = [v]
        for item in items:
            if sub is None:
                out.append(int(item or 0))
            else:
                out.extend(encode_table(sub, item))
    return out


def decode_table(schema, ints, pos: int = 0):
    """Inverse of `encode_table`: (nested dict, next position)."""
    rec = {}
    for field in schema:
        name, sub = field[0], (field[1] if len(field) > 1 else None)
        items = []
        for _ in range(field[2] if len(field) > 2 else 1):
            if sub is None:
                items.append(int(ints[pos]))
                pos += 1
            else:
                item, pos = decode_table(sub, ints, pos)
                items.append(item)
        rec[name] = items if len(field) > 2 else items[0]
    return rec, pos


# ---------------------------------------------------------------------------
# Packing a loaded module


@dataclasses.dataclass
class PackedNet:
    """A network's weights in one fp32 buffer and the int32 table the kernels
    walk (on the card for K2; K1 takes `table_host`, a copy in host memory,
    as its launch parameter); `layout` is the table read back
    (`decode_table`), which the plain version uses to find its weights.
    `sources` lists, in buffer order, the parameters the buffer was packed
    from (`pack_flat` packs them again, differentiably, from the live
    parameters).  `scratch` / `bwd_scratch` are K1's and K2's per-cloud
    memory, grown to the largest batch seen and reused (launches on one
    stream never overlap).

    K2's own: `table2` (`TABLE2`, on the card) and `layout2` read back;
    `jobs` / `tiles`, the products of its weight-gradient kernel and its
    blocks (an output tile and a depth part each; `_k2_jobs`), whose parts'
    sums take `splits` copies of the weights' size; `gather`, the index
    that makes [weights, every dense kernel transposed] from the weights.
    `bwd_buffers` puts these on the card once, beside the buffer that
    gather fills and the splits' partial sums, both sized once."""

    flat: torch.Tensor
    table: torch.Tensor
    layout: dict
    sources: list
    scratch: Optional[torch.Tensor] = None
    bwd_scratch: Optional[torch.Tensor] = None
    table_host: Optional[torch.Tensor] = None
    table2: Optional[torch.Tensor] = None
    layout2: Optional[dict] = None
    jobs: Optional[torch.Tensor] = None
    tiles: Optional[torch.Tensor] = None
    splits: int = 1
    gather: Optional[torch.Tensor] = None
    wcat: Optional[torch.Tensor] = None
    wpart: Optional[torch.Tensor] = None

    def scratch_for(self, batch: int) -> torch.Tensor:
        floats = batch * self.layout["cloud_floats"]
        if self.scratch is None or self.scratch.numel() < floats:
            self.scratch = torch.empty(floats, dtype=torch.float32,
                                       device=self.flat.device)
        return self.scratch

    def bwd_scratch_for(self, batch: int) -> torch.Tensor:
        floats = batch * self.layout2["bwd_floats"]
        if self.bwd_scratch is None or self.bwd_scratch.numel() < floats:
            self.bwd_scratch = torch.empty(floats, dtype=torch.float32,
                                           device=self.flat.device)
        return self.bwd_scratch

    def bwd_buffers(self) -> None:
        """K2's tables, the transposing gather and its output, and the weight
        gradient's partial sums (zeroed once: the kernel writes every entry
        of a weight or bias, never the padding) on the weights' card."""
        dev = self.flat.device
        if self.wpart is None:
            self.table2 = self.table2.to(dev)
            self.jobs, self.tiles = self.jobs.to(dev), self.tiles.to(dev)
            self.gather = self.gather.to(dev)
            self.wcat = torch.empty(2 * self.flat.numel(), dtype=torch.float32, device=dev)
            self.wpart = torch.zeros((self.splits, self.flat.numel()), dtype=torch.float32,
                                     device=dev)

    def live_flat(self) -> torch.Tensor:
        """The buffer packed from the parameters as they are now, with
        autograd's graph back to them."""
        return pack_flat(self.sources)


def pack_flat(sources) -> torch.Tensor:
    """One fp32 buffer from `(parameter, transpose, pad)` sources: dense
    kernels transposed to (in, out), each tensor padded to 32 floats."""
    parts = []
    zeros = None
    for p, transpose, pad in sources:
        parts.append((p.t() if transpose else p).float().reshape(-1))
        if pad:
            if zeros is None:
                zeros = p.new_zeros(32, dtype=torch.float32)
            parts.append(zeros[:pad])
    return torch.cat(parts)


class _Packer:
    def __init__(self):
        self.sources: list = []
        self.size = 0

    def add(self, p: torch.Tensor, transpose: bool = False) -> int:
        off = self.size
        pad = -p.numel() % 32          # 128-byte aligned tensors
        self.sources.append((p, transpose, pad))
        self.size += p.numel() + pad
        return off

    def dense(self, lin: nn.Linear) -> dict:
        w = self.add(lin.weight, transpose=True)         # (in, out), as flax
        b = self.add(lin.bias) if lin.bias is not None else -1
        return dict(w=w, b=b, cin=lin.in_features, cout=lin.out_features)

    def norm(self, mod) -> dict:
        gn = mod.group_norm if isinstance(mod, TailGroupNorm) else mod
        if not isinstance(gn, GroupNorm):
            raise TypeError(f"not a GroupNorm: {type(mod).__name__}")
        c = mod.channels if isinstance(mod, TailGroupNorm) else gn.weight.numel()
        return dict(s=self.add(gn.weight), b=self.add(gn.bias), c=c, g=gn.num_groups)

    def mlp(self, m) -> dict:
        layers = [m.first_mlp, m.second_mlp] + ([m.rest_mlp] if m.rest_mlp is not None
                                                else [])
        conv, norm = [], []
        for shared in layers:
            for i in range(1, len(shared.dims)):
                conv.append(self.dense(getattr(shared, f"conv_{i}")))
                norm.append(self.norm(getattr(shared, f"norm_{i}")))
        rec = dict(n_layers=len(conv), conv=conv, norm=norm,
                   inject_t=int(m.include_t), inject_c=int(m.include_condition),
                   res=1 if m.spec[0] == m.spec[-1] else 2)
        if m.include_t:
            rec["fc_t"] = self.dense(m.fc_t)
        if m.include_condition:
            rec["fc_c"] = self.dense(m.fc_condition)
        if rec["res"] == 2:
            rec["res_conv"] = self.dense(m.res_conv)
        return rec

    def att(self, a) -> dict:
        return dict(feat_conv=self.dense(a.feat_conv),
                    grouped_conv=self.dense(a.grouped_feat_conv),
                    w_norm_1=self.norm(a.w_norm_1), w_conv_1=self.dense(a.w_conv_1),
                    w_norm_2=self.norm(a.w_norm_2), w_conv_2=self.dense(a.w_conv_2),
                    out_conv=self.dense(a.feat_out_conv),
                    out_norm=self.norm(a.feat_out_norm))


def _records(rec, keys: set):
    """Every sub-record of a table record with the fields `keys`."""
    if isinstance(rec, dict):
        if keys <= rec.keys():
            yield rec
            return
        for v in rec.values():
            yield from _records(v, keys)
    elif isinstance(rec, list):
        for v in rec:
            yield from _records(v, keys)


def _tape_layout(rec: dict, rec2: dict, cmax: int) -> None:
    """K2's per-cloud scratch: give every tape and gradient field of `rec`
    (the layer table) and `rec2` (K2's) its offset, each tensor 32-float
    aligned, and set `bwd_floats`.  Rows are a cloud's, in order: grouped
    row i k + s of point i, so block r's rows (its points' and their slots')
    are one run; `cl` rows of per-block sums."""
    pos = 0
    n, cl = rec["n"], rec2["cluster"]

    def take(floats: int) -> int:
        nonlocal pos
        off = pos
        pos += -(-floats // 32) * 32
        return off

    def norm(nd):
        nd["p"] = take(cl * 2 * nd["c"])

    def mlp(m, rows):
        for i in range(m["n_layers"]):
            width = m["conv"][i]["cout"]
            m.setdefault("z", []).append(take(rows * width))
            m.setdefault("a", []).append(take(rows * width))
            m.setdefault("h", []).append(take(rows * width))
            m.setdefault("st", []).append(take(STATS))
            norm(m["norm"][i])
        width = m["conv"][m["n_layers"] - 1]["cout"]
        m["out"] = take(rows * width)
        m["dout"] = take(rows * width)
        m["dvt"] = take(cl * m["fc_t"]["cout"]) if m["inject_t"] else 0
        m["dvc"] = take(cl * m["fc_c"]["cout"]) if m["inject_c"] else 0

    def att(a, rows):
        ct = a["w_conv_1"]["cin"]
        inter, co = a["w_conv_1"]["cout"], a["w_conv_2"]["cout"]
        for key, floats in (("t", rows * ct), ("tn", rows * ct), ("st1", STATS),
                            ("u", rows * inter), ("st2", STATS), ("un", rows * inter),
                            ("s", rows * co), ("v", rows * co), ("st3", STATS),
                            ("vn", rows * co), ("w", rows * co),
                            ("df", n * a["feat_conv"]["cout"])):
            a[key] = take(floats)
        for key in ("w_norm_1", "w_norm_2", "out_norm"):
            norm(a[key])

    rmax = n
    for s in rec["sa"]:
        rows = n * s["k"]
        rmax = max(rmax, rows)
        mlp(s["mlp"], rows)
        att(s["att"], rows)
        s["x"] = take(rows * s["mlp"]["conv"][0]["cin"])
    for f in rec["fp"]:
        rows = n * f["k"]
        rmax = max(rmax, rows)
        mlp(f["mlp1"], rows)
        att(f["att"], rows)
        mlp(f["mlp2"], n)
        f["x"] = take(rows * f["mlp1"]["conv"][0]["cin"])
        f["nf"] = take(n * f["mlp2"]["conv"][0]["cin"])
    rec2["flvl"] = [take(n * cmax) for _ in range(MAX_LEVELS + 1)]
    rec2["hin"] = take(n * rec["head1"]["cin"])
    rec2["hz"] = take(n * rec["head1"]["cout"])
    rec2["hst"] = take(STATS)
    rec2["ha"] = take(n * rec["head1"]["cout"])
    norm(rec["head_norm"])
    # row buffers: a block's rows start at its first row x gld, whatever the
    # width it keeps there
    rec2["gbuf"] = [take(rmax * cmax) for _ in range(N_GRAD_BUFFERS)]
    rec2["gld"] = cmax
    rec2["gf"] = [take(n * cmax) for _ in range(MAX_LEVELS + 1)]
    rec2["gdist"] = take(n * n)
    rec2["gxyz"] = take(n * 3)
    rec2["gvec"] = take(rec["t4"] + rec["cls"])
    rec2["bwd_floats"] = pos


def _k2_stream(rec: dict, P: int, size: int) -> list:
    """K2's products in the order it runs them: (weight offset, depth, width,
    rows per block).  The recompute's are K1's but the head's last (its
    output is not needed); the backward's, d input = d output W^T, read the
    transposed weights at `size` + the weight's offset."""
    out: list = []

    def fwd(d, rows):
        out.append((d["w"], d["cin"], d["cout"], rows))

    def bwd(d, rows):
        out.append((size + d["w"], d["cout"], d["cin"], rows))

    def mlp_f(m, rows):
        for i in range(m["n_layers"]):
            fwd(m["conv"][i], rows)
        if m["res"] == 2:
            fwd(m["res_conv"], rows)

    def mlp_b(m, rows):
        if m["res"] == 2:
            bwd(m["res_conv"], rows)
        for i in reversed(range(m["n_layers"])):
            bwd(m["conv"][i], rows)

    def att_f(a, k):
        for key, rows in (("grouped_conv", P * k), ("feat_conv", P), ("w_conv_1", P * k),
                          ("w_conv_2", P * k), ("out_conv", P * k)):
            fwd(a[key], rows)

    def att_b(a, k):
        for key, rows in (("out_conv", P * k), ("w_conv_2", P * k), ("w_conv_1", P * k),
                          ("feat_conv", P), ("grouped_conv", P * k)):
            bwd(a[key], rows)

    for s in rec["sa"]:
        mlp_f(s["mlp"], P * s["k"])
        att_f(s["att"], s["k"])
    for f in reversed(rec["fp"]):
        mlp_f(f["mlp1"], P * f["k"])
        att_f(f["att"], f["k"])
        mlp_f(f["mlp2"], P)
    fwd(rec["head1"], P)
    bwd(rec["head_out"], P)
    bwd(rec["head1"], P)
    for f in rec["fp"]:
        mlp_b(f["mlp2"], P)
        att_b(f["att"], f["k"])
        mlp_b(f["mlp1"], P * f["k"])
    for s in reversed(rec["sa"]):
        att_b(s["att"], s["k"])
        mlp_b(s["mlp"], P * s["k"])
    return out


def _stream_entries(stream, stage: int) -> list:
    """A list of products as `_STREAM` records for a ring of `stage`-float
    stages: 32 rows a pass (mt 2) up to 512 columns, else 16; depth slices
    of the most rows of 8 that fit a stage."""
    entries = []
    for w, cin, cout, rows in stream:
        mt = 2 if cout <= 512 and rows > 16 else 1
        bk = min(8 * ((stage - 8) // (8 * cout)), -(-cin // 8) * 8)
        entries.append(dict(w=w, cin=cin, cout=cout, bk=bk,
                            passes=max(1, -(-rows // (16 * mt))), mt=mt))
    return entries


def _k2_plan(rec: dict, size: int) -> dict:
    """K2's plan (`TABLE2`): (4, 2) of `K2_PLACEMENTS` when its products fit
    the registers and its shared memory fits, else (8, 1); in it, ring
    stages as large as fit (as K1's).  Shared memory: the ring's barriers,
    K2's plan and its pointers (128 floats), both tables, the ring, then
    the small tables."""
    n = rec["n"]
    kmax = max([1] + [s["k"] for s in rec["sa"]] + [f["k"] for f in rec["fp"]])
    red = 512 * max(1, -(-max(nd["c"] for nd in _records(rec, {"s", "b", "c", "g"})) // 256))
    for cl, occ in K2_PLACEMENTS:
        P = -(-n // cl)
        stream = _k2_stream(rec, P, size)
        if len(stream) > K2_MAX_STREAM:
            raise ValueError(f"K2 runs at most {K2_MAX_STREAM} weight products, got "
                             f"{len(stream)}")
        widest = max(cout for _, _, cout, _ in stream)
        if occ == 2 and widest > K2_WIDE_2:
            continue
        least = -(-(8 * widest + 8) // 32) * 32
        sizes = {-(-(bk * cout + 8) // 32) * 32 for _, _, cout, _ in stream
                 for bk in (8, 16, 32, 64, 128)} | {8192}
        sizes = sorted((z for z in sizes if least <= z <= 8224), reverse=True) or [least]
        for stage in sizes:
            pos = 128
            fields = dict(cluster=cl, occupancy=occ, pts=P, kmax=kmax, bars=0, stage=stage)
            for key, floats in (("table", table_ints()), ("table2", table_ints(TABLE2)),
                                ("ring", K1_STAGES * stage), ("xyz", n * 3), ("dist", n * n),
                                ("knn", n * kmax), ("picks", P * (n + 1)),
                                ("part", 4 * MAX_GROUPS), ("gn", 5 * MAX_GROUPS),
                                ("red", red), ("vecs", MAX_VEC), ("cs", 2 * MAX_VEC)):
                fields[key] = pos
                pos += -(-floats // 32) * 32
            fields["smem_bytes"] = 4 * pos
            if fields["smem_bytes"] <= (K1_SMEM_BYTES_2 if occ == 2 else K1_SMEM_BYTES):
                fields["stream"] = _stream_entries(stream, stage)
                fields["n_stream"] = len(stream)
                return fields
    raise ValueError("K2's plan fits no placement")


def _k2_jobs(rec: dict, rec2: dict):
    """K2's weight-gradient kernel: one job per weight and per GroupNorm
    affine, d W = sum over the batch's clouds and their rows of X^T dY (and
    d bias = sum dY), as int rows [d W's offset (-1: none), d bias's offset
    (-1: none), in (0: a column sum only), out, rows per cloud, X's source,
    offset, row stride, dY's source, offset, row stride, 0];
    sources TAPE (the cloud's tape), FROM_T4 / FROM_CLS (the cloud's
    embedding, one row read for every row: stride 0) and FROM_G (the
    cotangent).  Then its blocks [job, first in, first out, depth part,
    parts, 0, 0, 0], one per output tile and depth part, and the most parts
    a job has."""
    n, cl = rec["n"], rec2["cluster"]
    jobs: list = []

    def prod(d, rows, x, y):
        jobs.append([d["w"], d["b"], d["cin"], d["cout"], rows, *x, *y, 0])

    def norm(nd):
        c, cn = nd["c"], nd["c"] - nd["c"] % nd["g"]
        for dst, col in ((nd["s"], 0), (nd["b"], c)):
            jobs.append([-1, dst, 0, cn, cl, TAPE, 0, 0, TAPE, nd["p"] + col, 2 * c, 0])

    def mlp(m, xoff, rows):
        for i in range(m["n_layers"]):
            cv = m["conv"][i]
            if i == 0:
                src = xoff
            else:
                inj = (i - 1 == 0 and m["inject_t"]) or (i - 1 == 1 and m["inject_c"])
                src = m["h"][i - 1] if inj else m["a"][i - 1]
            prod(cv, rows, (TAPE, src, cv["cin"]), (TAPE, m["z"][i], cv["cout"]))
            norm(m["norm"][i])
        if m["inject_t"]:
            prod(m["fc_t"], cl, (FROM_T4, 0, 0), (TAPE, m["dvt"], m["fc_t"]["cout"]))
        if m["inject_c"]:
            prod(m["fc_c"], cl, (FROM_CLS, 0, 0), (TAPE, m["dvc"], m["fc_c"]["cout"]))
        if m["res"] == 2:
            cout = m["conv"][m["n_layers"] - 1]["cout"]
            prod(m["res_conv"], rows, (TAPE, xoff, m["res_conv"]["cin"]),
                 (TAPE, m["dout"], cout))

    def att(a, feat, grouped, value, k):
        ct, c1 = a["w_conv_1"]["cin"], a["feat_conv"]["cout"]
        inter, co = a["w_conv_1"]["cout"], a["w_conv_2"]["cout"]
        prod(a["feat_conv"], n, (TAPE, feat, a["feat_conv"]["cin"]), (TAPE, a["df"], c1))
        prod(a["grouped_conv"], n * k, (TAPE, grouped, a["grouped_conv"]["cin"]),
             (TAPE, a["t"] + c1, ct))
        prod(a["w_conv_1"], n * k, (TAPE, a["tn"], ct), (TAPE, a["u"], inter))
        prod(a["w_conv_2"], n * k, (TAPE, a["un"], inter), (TAPE, a["s"], co))
        prod(a["out_conv"], n * k, (TAPE, value, a["out_conv"]["cin"]), (TAPE, a["v"], co))
        for key in ("w_norm_1", "w_norm_2", "out_norm"):
            norm(a[key])

    for l, s in enumerate(rec["sa"]):
        mlp(s["mlp"], s["x"], n * s["k"])
        att(s["att"], rec2["flvl"][l], s["x"], s["mlp"]["out"], s["k"])
    for l, f in enumerate(rec["fp"]):
        mlp(f["mlp1"], f["x"], n * f["k"])
        att(f["att"], rec2["flvl"][l], f["x"], f["mlp1"]["out"], f["k"])
        mlp(f["mlp2"], f["nf"], n)
    hc = rec["head1"]["cout"]
    prod(rec["head1"], n, (TAPE, rec2["hin"], rec["head1"]["cin"]), (TAPE, rec2["hz"], hc))
    norm(rec["head_norm"])
    prod(rec["head_out"], n, (TAPE, rec2["ha"], hc), (FROM_G, 0, rec["out_dim"]))
    blocks = []
    for j, job in enumerate(jobs):
        parts = max(1, min(DW_MAX_SPLITS, job[4] // DW_PART_ROWS))
        for m0 in range(0, max(job[2], 1), DW_TILE):
            for n0 in range(0, job[3], DW_TILE):
                blocks += [[j, m0, n0, part, parts, 0, 0, 0] for part in range(parts)]
    return jobs, blocks, max(b[4] for b in blocks)


def _transpose_gather(rec: dict, size: int) -> torch.Tensor:
    """Indices into the weights of [the weights, the weights with every
    dense kernel (cin, cout) stored transposed, (cout, cin), at the same
    offset]: K2's d input products read the second half."""
    idx = torch.arange(size, dtype=torch.int64)
    for d in _records(rec, {"w", "b", "cin", "cout"}):
        cin, cout = d["cin"], d["cout"]
        src = torch.arange(cin * cout, dtype=torch.int64).view(cin, cout)
        idx[d["w"]:d["w"] + cin * cout] = d["w"] + src.t().reshape(-1)
    return torch.cat([torch.arange(size, dtype=torch.int64), idx]).to(torch.int32)


def _ld(width: int) -> int:
    """The row stride K1 gives `width` channels: the least >= width that is 4
    mod 8 (a tensor-core fragment's 8 rows x 4 columns then fall in 32
    different shared-memory banks)."""
    return width + (4 - width) % 8


def _k1_plan(rec: dict) -> None:
    """K1's plan, into `rec`: each block owns `pts` points and their grouped
    rows; per level the row stride `ld`; the weight stream (every product in
    the order K1 runs it: rows per block, passes of 16 * mt rows, depth
    slices of bk rows per ring stage); the t / class injection vectors'
    offsets; and where everything lives: shared memory (offsets in floats,
    `smem_bytes` in all) or, for a row buffer that does not fit, the block's
    device scratch (`bglob`, `blk_floats`); blocks per SM (`occupancy`): the
    first of `K1_PLACEMENTS` that fits.  Per cloud, the device scratch holds
    the 8 blocks' scratch and their injection partials (`vec`)."""
    n, din = rec["n"], rec["din"]
    P = -(-n // K1_CLUSTER)
    sa, fp = rec["sa"], rec["fp"]
    ks = [s["k"] for s in sa] + [f["k"] for f in fp]
    stream: list = []

    def dense(d, rows):
        stream.append((d, rows))

    def mlp(m, rows):
        for i in range(m["n_layers"]):
            dense(m["conv"][i], rows)
        if m["res"] == 2:
            dense(m["res_conv"], rows)
        convs = m["conv"][:m["n_layers"]]
        return [c["cout"] for c in convs] + [convs[0]["cin"]]

    def att(a, k):
        for key, rows in (("grouped_conv", P * k), ("feat_conv", P), ("w_conv_1", P * k),
                          ("w_conv_2", P * k), ("out_conv", P * k)):
            dense(a[key], rows)
        return [a["grouped_conv"]["cin"], a["feat_conv"]["cout"] + a["grouped_conv"]["cout"],
                a["w_conv_1"]["cout"], a["w_conv_2"]["cout"], a["out_conv"]["cin"]]

    rows_x_ld = []
    for s in sa:
        s["ld"] = _ld(max(mlp(s["mlp"], P * s["k"]) + att(s["att"], s["k"])))
        rows_x_ld.append(P * s["k"] * s["ld"])
    for f in reversed(fp):
        widths = mlp(f["mlp1"], P * f["k"]) + att(f["att"], f["k"])
        widths += mlp(f["mlp2"], P)[:-1]            # its input is the point buffer
        f["ld"] = _ld(max(widths))
        rows_x_ld.append(P * f["k"] * f["ld"])
    dense(rec["head1"], P)
    dense(rec["head_out"], P)
    rec["hld"] = _ld(rec["head1"]["cout"])
    rows_x_ld.append(P * rec["hld"])
    if len(stream) > MAX_STREAM:
        raise ValueError(f"K1 runs at most {MAX_STREAM} weight products, got {len(stream)}")

    # a ring stage holds at least 8 depth rows of the widest product (bk
    # rows of each, a multiple of 8, copied as one span, and 8 floats to
    # spare: a fragment load may run 7 columns past the width)
    least = -(-(8 * max(d["cout"] for d, _ in stream) + 8) // 32) * 32
    rec["n_stream"] = len(stream)

    # the injection vectors of every MLP
    inj = 0
    mlps = [s["mlp"] for s in sa] + [m for f in fp for m in (f["mlp1"], f["mlp2"])]
    for m in mlps:
        for flag, fc, key in (("inject_t", "fc_t", "vt"), ("inject_c", "fc_c", "vc")):
            m[key] = inj if m[flag] else 0
            inj += m[fc]["cout"] if m[flag] else 0

    # shared memory: the ring's barriers, this table (K1 reads it there),
    # the ring, the small tables, the blocks' own level features, the point
    # buffer, then the row buffers
    lcap = [din] + [s["att"]["w_conv_2"]["cout"] for s in sa]
    for i, f in enumerate(fp):
        lcap[i] = max(lcap[i], f["mlp2"]["conv"][f["mlp2"]["n_layers"] - 1]["cout"])
    pwidths = [rec["head1"]["cin"]] + [f["mlp2"]["conv"][0]["cin"] for f in fp]
    rec.update(pts=P, kmax=max([1] + ks), inj=inj, pld=_ld(max(pwidths)),
               lcap=lcap + [0] * (MAX_LEVELS + 1 - len(lcap)))
    big = -(-max(rows_x_ld) // 32) * 32
    # GroupNorm's column sums: 2 x 256 floats per 256 channels of the widest;
    # the widest injection vector
    red = 512 * max(1, -(-max(nd["c"] for nd in _records(rec, {"s", "b", "c", "g"})) // 256))
    vecs = max([1] + [m[fc]["cout"] for m in mlps for flag, fc in
                      (("inject_t", "fc_t"), ("inject_c", "fc_c")) if m[flag]])

    def layout(stage, glob):
        pos = 64                     # the ring's 2 * K1_STAGES + 1 barriers, then K1's `Plan`
        fields = dict(bars=0, table=pos, stage=stage)
        pos += -(-table_ints() // 32) * 32
        fields["ring"] = pos
        pos += K1_STAGES * stage
        for key, floats in (("xyz", n * 3), ("dist", P * n), ("knn", P * rec["kmax"]),
                            ("part", 4 * MAX_GROUPS), ("gn", 2 * MAX_GROUPS), ("red", red),
                            ("vecs", vecs), ("pbuf", P * rec["pld"])):
            fields[key] = pos
            pos += -(-floats // 32) * 32
        fields["lvl"] = []
        for cap in lcap:
            fields["lvl"].append(pos)
            pos += -(-P * cap // 32) * 32
        fields["lvl"] += [0] * (MAX_LEVELS + 1 - len(lcap))
        fields["buf"], gpos = [], 0
        for g in glob:
            fields["buf"].append(gpos if g else pos)
            if g:
                gpos += big
            else:
                pos += big
        fields.update(bglob=list(glob), blk_floats=gpos, smem_bytes=4 * pos)
        return fields

    # the first placement that fits; in each, ring stages as large as fit
    # (fewer, larger stages measured faster): 32 KB, or a size up to 16 rows
    # of 1024 floats that holds 8 to 128 rows of some product
    sizes = {-(-(bk * d["cout"] + 8) // 32) * 32 for d, _ in stream
             for bk in (8, 16, 32, 64, 128)} | {8192}
    sizes = sorted((z for z in sizes if least <= z <= 8224), reverse=True) or [least]
    plans = [(occ, stage, glob) for occ, glob in K1_PLACEMENTS for stage in sizes]
    for occ, *plan in plans:
        fields = layout(*plan)
        if fields["smem_bytes"] <= (K1_SMEM_BYTES_2 if occ == 2 else K1_SMEM_BYTES):
            fields["occupancy"] = occ
            break
    else:
        raise ValueError(f"K1 needs {fields['smem_bytes']} bytes of shared memory, the "
                         f"card gives {K1_SMEM_BYTES}")
    rec.update(fields)
    rec["stream"] = []
    for d, rows in stream:
        mt = 2 if d["cout"] <= 512 and rows > 16 else 1
        bk = min(8 * ((rec["stage"] - 8) // (8 * d["cout"])), -(-d["cin"] // 8) * 8)
        rec["stream"].append(dict(w=d["w"], cin=d["cin"], cout=d["cout"], bk=bk,
                                  passes=max(1, -(-rows // (16 * mt))), mt=mt))
    rec["vec"] = K1_CLUSTER * rec["blk_floats"]
    rec["cloud_floats"] = rec["vec"] + -(-K1_CLUSTER * inj // 32) * 32


def pack_weights(net: ConditionalPointNet2, spec: Mapping) -> PackedNet:
    """Pack a loaded port `ConditionalPointNet2` (weights from
    `weights.load_flax_params`) into one fp32 buffer and the kernels' table,
    on the module's device.  `spec` is `build_spec` of its config; raises
    when it is past the kernels' limits (`limits_error`)."""
    err = limits_error(spec)
    if err is not None:
        raise ValueError(err)
    p = _Packer()
    n = spec["n"]
    rec = dict(n=n, din=spec["in_fea"], out_dim=spec["out_dim"], t4=spec["t4"],
               cls=spec["cls"], inc_abs=int(spec["extra"][0]),
               inc_cen=int(spec["extra"][1]), n_sa=len(spec["sa"]),
               n_fp=len(spec["fp"]))
    rec["sa"] = [dict(k=s["k"], mlp=p.mlp(m.mlp), att=p.att(m.attention))
                 for s, m in zip(spec["sa"], net.sa_modules)]
    rec["fp"] = [dict(k=s["k"], mlp1=p.mlp(m.mlp1), att=p.att(m.attention),
                      mlp2=p.mlp(m.mlp2))
                 for s, m in zip(spec["fp"], net.fp_modules)]
    rec["head1"] = p.dense(net.head_conv1)
    rec["head_norm"] = p.norm(net.head_norm)
    rec["head_out"] = p.dense(net.head_conv_out)

    cmax = max(max(d["cin"], d["cout"]) for d in _records(rec, {"w", "b", "cin", "cout"}))
    if cmax > MAX_VEC or max(spec["t4"], spec["cls"]) > MAX_VEC:
        raise ValueError(f"the fused kernels take widths up to {MAX_VEC}, got "
                         f"{max(cmax, spec['t4'], spec['cls'])}")
    if max(nd["g"] for nd in _records(rec, {"s", "b", "c", "g"})) > MAX_GROUPS:
        raise ValueError(f"the fused kernels take at most {MAX_GROUPS} GroupNorm groups")
    _k1_plan(rec)
    rec2 = _k2_plan(rec, p.size)
    _tape_layout(rec, rec2, cmax)
    jobs, tiles, splits = _k2_jobs(rec, rec2)

    ints = encode_table(TABLE, rec)
    ints2 = encode_table(TABLE2, rec2)
    dev = net.head_conv1.weight.device
    with torch.no_grad():
        flat = pack_flat(p.sources).to(dev).contiguous()
    table_host = torch.tensor(ints, dtype=torch.int32)
    layout, _ = decode_table(TABLE, ints)
    layout2, _ = decode_table(TABLE2, ints2)
    return PackedNet(flat=flat, table=table_host.to(dev), layout=layout, sources=p.sources,
                     table_host=table_host, table2=torch.tensor(ints2, dtype=torch.int32),
                     layout2=layout2, jobs=torch.tensor(jobs, dtype=torch.int32),
                     tiles=torch.tensor(tiles, dtype=torch.int32), splits=splits,
                     gather=_transpose_gather(rec, p.size))


# ---------------------------------------------------------------------------
# The plain PyTorch version


def _dense(x: torch.Tensor, flat: torch.Tensor, d: Mapping) -> torch.Tensor:
    w = flat[d["w"]:d["w"] + d["cin"] * d["cout"]].view(d["cin"], d["cout"])
    y = torch.matmul(x, w)
    if d["b"] >= 0:
        y = y + flat[d["b"]:d["b"] + d["cout"]]
    return y


def _group_norm(x: torch.Tensor, flat: torch.Tensor, nd: Mapping) -> torch.Tensor:
    """Tail GroupNorm per sample over (rows, group channels); x (B, R, C)."""
    b, r, c = x.shape
    g = nd["g"]
    c_norm = c - c % g
    gsize = c_norm // g
    xn = x[..., :c_norm].reshape(b, r, g, gsize)
    cnt = float(r * gsize)
    mean = xn.sum(dim=(1, 3)) / cnt
    m2 = (xn * xn).sum(dim=(1, 3)) / cnt
    var = torch.maximum(m2 - mean * mean, mean.new_zeros(()))
    inv = torch.rsqrt(var + _EPS)
    y = (xn - mean[:, None, :, None]) * inv[:, None, :, None]
    y = y.reshape(b, r, c_norm) * flat[nd["s"]:nd["s"] + c_norm] \
        + flat[nd["b"]:nd["b"] + c_norm]
    if c_norm == c:
        return y
    return torch.cat([y, x[..., c_norm:]], dim=-1)


def _mlp(x, flat, m, t4=None, cls=None, relu=torch.relu):
    """InjectionMLP: conv -> GN -> relu per layer, t added after the first
    layer, the class after the second, then the residual.  x (B, R, C)."""
    h = x
    for i in range(m["n_layers"]):
        h = relu(_group_norm(_dense(h, flat, m["conv"][i]), flat, m["norm"][i]))
        if i == 0 and m["inject_t"]:
            h = h + _dense(t4, flat, m["fc_t"])[:, None, :]
        if i == 1 and m["inject_c"]:
            h = h + _dense(cls, flat, m["fc_c"])[:, None, :]
    return h + (x if m["res"] == 1 else _dense(x, flat, m["res_conv"]))


def _attention(feat, grouped, value, flat, a, k: int, relu=torch.relu):
    """AttentionPool with every slot valid.  feat (B, N, Cq), grouped
    (B, N*k, Cg), value (B, N*k, Cv) -> (B, N, c_out)."""
    b, n, _ = feat.shape
    f1 = torch.repeat_interleave(_dense(feat, flat, a["feat_conv"]), k, dim=1)
    g1 = _dense(grouped, flat, a["grouped_conv"])
    h = _group_norm(relu(torch.cat([f1, g1], dim=-1)), flat, a["w_norm_1"])
    h = _group_norm(relu(_dense(h, flat, a["w_conv_1"])), flat, a["w_norm_2"])
    scores = _dense(h, flat, a["w_conv_2"]).reshape(b, n, k, -1)
    scores = scores - scores.amax(dim=2, keepdim=True)
    v = relu(_group_norm(_dense(value, flat, a["out_conv"]), flat, a["out_norm"]))
    e = torch.exp(scores)
    weight = e / e.sum(dim=2, keepdim=True)
    return (v.reshape(b, n, k, -1) * weight).sum(dim=2)


def pairwise_sqdist(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N, N): max((|x|^2 + |y|^2) - 2<x, y>, 0), every sum
    and product a separate fp32 operation in this order (the kernel's).  The
    clamp is `torch.maximum`: at a tie (every self-distance is exactly 0) its
    gradient is 0.5, as `jnp.maximum`'s is."""
    x0, x1, x2 = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sq = (x0 * x0 + x1 * x1) + x2 * x2
    a, c = xyz[:, :, None, :], xyz[:, None, :, :]
    xy = (a[..., 0] * c[..., 0] + a[..., 1] * c[..., 1]) + a[..., 2] * c[..., 2]
    return torch.maximum((sq[:, :, None] + sq[:, None, :]) - 2.0 * xy, xyz.new_zeros(()))


def knn_from_sqdist(d: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, N) -> (B, N, k) indices of the k smallest, ascending, ties to
    the lowest index."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _group(xyz, feats, d, k: int, inc_abs: bool, inc_cen: bool,
           knn_channels: bool = False) -> torch.Tensor:
    """Neighbourhoods of every point in the same cloud: (B, N*k, C')."""
    b, n, _ = xyz.shape
    if k == n and not knn_channels:
        # full neighbourhood: slot j = point j (index order)
        nn_abs = xyz[:, None, :, :].expand(b, n, n, 3)
        gf = feats[:, None, :, :].expand(b, n, n, feats.shape[-1])
    else:
        idx = knn_from_sqdist(d, k)
        rows = torch.arange(b, device=xyz.device)[:, None, None]
        nn_abs, gf = xyz[rows, idx], feats[rows, idx]
    center = xyz[:, :, None, :].expand_as(nn_abs)
    rel = nn_abs - center
    if knn_channels:
        dk = torch.gather(d, 2, idx)[..., None]
        recip = 1.0 / (dk + 1e-8)
        wgt = recip / recip.sum(dim=2, keepdim=True)
        parts = [gf, dk, wgt, nn_abs, rel, center]
    else:
        parts = [gf, rel] + ([nn_abs] if inc_abs else []) + ([center] if inc_cen else [])
    return torch.cat(parts, dim=-1).reshape(b, n * k, -1)


def fused_forward_plain(spec: Mapping, packed: PackedNet, pc: torch.Tensor,
                        t4: torch.Tensor, cls: torch.Tensor,
                        flat: Optional[torch.Tensor] = None,
                        relu=torch.relu) -> torch.Tensor:
    """pc (B, N, 3 + in_fea_dim) noisy cloud, t4 (B, 4 t_dim) timestep
    embedding, cls (B, class_dim) class embedding -> (B, N, out_dim).  The
    weights are `flat` (laid out as `packed.flat`), `packed.flat` if None;
    every relu is a call of `relu`."""
    lay = packed.layout
    flat = packed.flat if flat is None else flat
    inc_abs, inc_cen = bool(lay["inc_abs"]), bool(lay["inc_cen"])
    xyz = pc[..., :3]
    feats = [torch.cat([pc[..., 3:], xyz], dim=-1)]   # attach_position
    d = pairwise_sqdist(xyz)

    for s in lay["sa"][:lay["n_sa"]]:
        grouped = _group(xyz, feats[-1], d, s["k"], inc_abs, inc_cen)
        out = _mlp(grouped, flat, s["mlp"], t4, cls, relu)
        feats.append(_attention(feats[-1], grouped, out, flat, s["att"], s["k"], relu))

    for i in range(lay["n_fp"] - 1, -1, -1):
        f = lay["fp"][i]
        grouped = _group(xyz, feats[i + 1], d, f["k"], inc_abs, inc_cen,
                         knn_channels=True)
        out1 = _mlp(grouped, flat, f["mlp1"], relu=relu)
        interp = _attention(feats[i], grouped, out1, flat, f["att"], f["k"], relu)
        nf = torch.cat([interp, feats[i], xyz], dim=-1)
        feats[i] = _mlp(nf, flat, f["mlp2"], t4, cls, relu)

    h = _dense(torch.cat([feats[0], xyz], dim=-1), flat, lay["head1"])
    h = relu(_group_norm(h, flat, lay["head_norm"]))
    out = _dense(h, flat, lay["head_out"])
    if spec is not None and out.shape[-1] != spec["out_dim"]:
        raise ValueError("packed net and spec disagree on out_dim")
    return out


# ---------------------------------------------------------------------------
# The kernels' wrappers and the entry points

def _check_cuda(what: str, packed: PackedNet, tensors: Mapping[str, torch.Tensor],
                shapes: Mapping[str, tuple]) -> None:
    """Raise unless every tensor is contiguous fp32 on the packed net's card
    with the given shape, and the table is int32 there."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != packed.flat.device:
            raise ValueError(f"{what}: {name} must be on the packed net's card "
                             f"{packed.flat.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{what}: {name} must be {tuple(shapes[name])}, got "
                             f"{tuple(t.shape)}")
    if packed.table.device != packed.flat.device or packed.table.dtype != torch.int32:
        raise ValueError(f"{what}: the table must be int32 on the card")


def _load_checked(packed: PackedNet):
    lib = _build.load_kernels()
    if lib.slide_fused_table_ints() != packed.table.numel():
        raise RuntimeError(f"layer table has {packed.table.numel()} ints, the "
                           f"kernel's Spec {lib.slide_fused_table_ints()}")
    if lib.slide_fused_table2_ints() != packed.table2.numel():
        raise RuntimeError(f"K2's table has {packed.table2.numel()} ints, the "
                           f"kernel's Spec2 {lib.slide_fused_table2_ints()}")
    return lib


def _io_shapes(lay: Mapping, b: int) -> dict:
    return {"pc": (b, lay["n"], lay["din"]), "t4": (b, lay["t4"]), "cls": (b, lay["cls"]),
            "g": (b, lay["n"], lay["out_dim"])}


def fused_forward_cuda(packed: PackedNet, pc: torch.Tensor, t4: torch.Tensor,
                       cls: torch.Tensor, flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 (`csrc/fused_denoiser.cu`), one cluster of blocks per cloud,
    over the weights `flat` (laid out as `packed.flat`, which is the default;
    16-byte aligned: the kernel copies its slices with bulk copies).  Takes
    contiguous fp32 CUDA tensors of the packed net's widths; raises on
    anything else."""
    lay = packed.layout
    flat = packed.flat if flat is None else flat
    b = pc.shape[0]
    if b == 0:
        raise ValueError("fused_forward_cuda: empty batch")
    shapes = {**_io_shapes(lay, b), "weights": tuple(packed.flat.shape)}
    _check_cuda("fused_forward_cuda", packed,
                {"pc": pc, "t4": t4, "cls": cls, "weights": flat}, shapes)
    if flat.data_ptr() % 16:
        raise ValueError("fused_forward_cuda: the weights must be 16-byte aligned")
    dev = pc.device
    lib = _load_checked(packed)
    out = torch.empty((b, lay["n"], lay["out_dim"]), dtype=torch.float32, device=dev)
    scratch = packed.scratch_for(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slide_fused_denoiser(pc.data_ptr(), t4.data_ptr(), cls.data_ptr(),
                                    flat.data_ptr(), packed.table_host.data_ptr(),
                                    scratch.data_ptr(), out.data_ptr(), b,
                                    lay["smem_bytes"], dev.index, stream)
    _build.check(lib, code, "fused_denoiser")
    _build.launch_counts["fused_denoiser"] += 1
    return out


def fused_backward_cuda(packed: PackedNet, pc: torch.Tensor, t4: torch.Tensor,
                        cls: torch.Tensor, g: torch.Tensor,
                        flat: Optional[torch.Tensor] = None):
    """Launch K2 (`csrc/fused_denoiser_bwd.cu`): the VJP of the fused forward
    at (pc, t4, cls, flat) applied to the cotangent g (B, N, out_dim).
    Returns (d pc, d t4, d cls, d flat), d flat summed over the batch in a
    fixed order (two launches on the same inputs give equal results).
    Takes contiguous fp32 CUDA tensors; raises on anything else.

    Before the launch one gather (`PackedNet.gather`) lays out the weights
    and their transposes for K2's d input products; its buffer and every
    other scratch K2 needs are sized once on `packed`."""
    lay, lay2 = packed.layout, packed.layout2
    flat = packed.flat if flat is None else flat
    b = pc.shape[0]
    if b == 0:
        raise ValueError("fused_backward_cuda: empty batch")
    shapes = {**_io_shapes(lay, b), "weights": tuple(packed.flat.shape)}
    _check_cuda("fused_backward_cuda", packed,
                {"pc": pc, "t4": t4, "cls": cls, "g": g, "weights": flat}, shapes)
    dev = pc.device
    lib = _load_checked(packed)
    packed.bwd_buffers()
    size = flat.numel()
    torch.index_select(flat.detach(), 0, packed.gather, out=packed.wcat)
    dpc, dt4, dcls = torch.empty_like(pc), torch.empty_like(t4), torch.empty_like(cls)
    dflat = torch.empty_like(flat)
    scratch = packed.bwd_scratch_for(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slide_fused_denoiser_bwd(
        pc.data_ptr(), t4.data_ptr(), cls.data_ptr(), g.data_ptr(), packed.wcat.data_ptr(),
        packed.table.data_ptr(), packed.table2.data_ptr(), scratch.data_ptr(),
        packed.jobs.data_ptr(), packed.tiles.data_ptr(), packed.tiles.shape[0], packed.splits,
        packed.wpart.data_ptr(), dpc.data_ptr(), dt4.data_ptr(), dcls.data_ptr(),
        dflat.data_ptr(), b, size, lay2["cluster"], lay2["occupancy"], lay2["smem_bytes"],
        lay2["bwd_floats"], lay["t4"], lay["cls"], lay["n"] * lay["out_dim"], dev.index, stream)
    _build.check(lib, code, "fused_denoiser_bwd")
    _build.launch_counts["fused_denoiser_bwd"] += 1
    return dpc, dt4, dcls, dflat


def weight_grads_plain(packed: PackedNet, tape: torch.Tensor, t4: torch.Tensor,
                       cls: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of K2's weight-gradient launch: d flat from the
    chain's tape (B x bwd_floats) and the inputs, job by job (`_k2_jobs`):
    d W = sum over clouds and rows of X^T dY, d bias = sum of dY."""
    b = t4.shape[0]
    floats = packed.layout2["bwd_floats"]
    tape = tape.reshape(-1)[:b * floats]
    out = torch.zeros(packed.flat.numel(), dtype=torch.float32, device=tape.device)
    flat_rows = {FROM_T4: t4.reshape(b, -1), FROM_CLS: cls.reshape(b, -1),
                 FROM_G: g.reshape(b, -1)}

    def rows(kind, off, ld, r, width):
        if kind == TAPE:
            return tape.as_strided((b, r, width), (floats, ld, 1), off)
        src = flat_rows[kind]
        return src.as_strided((b, r, width), (src.shape[1], ld, 1), off)

    for dst_w, dst_b, cin, cout, r, xk, xoff, xld, yk, yoff, yld, _ in packed.jobs.tolist():
        y = rows(yk, yoff, yld, r, cout)
        if cin > 0:
            x = rows(xk, xoff, xld, r, cin)
            out[dst_w:dst_w + cin * cout] = torch.einsum("bri,brc->ic", x, y).reshape(-1)
        if dst_b >= 0:
            out[dst_b:dst_b + cout] = y.sum(dim=(0, 1))
    return out


def fused_backward_plain(packed: PackedNet, pc: torch.Tensor, t4: torch.Tensor,
                         cls: torch.Tensor, g: torch.Tensor,
                         flat: Optional[torch.Tensor] = None):
    """K2's plain version: autograd through `fused_forward_plain`, recomputed
    here.  Returns (d pc, d t4, d cls, d flat)."""
    flat = packed.flat if flat is None else flat
    inputs = [t.detach().requires_grad_(True) for t in (pc, t4, cls, flat)]
    with torch.enable_grad():
        out = fused_forward_plain(None, packed, *inputs)
        grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
    return tuple(torch.zeros_like(x) if d is None else d for x, d in zip(inputs, grads))


def fused_backward_reference(packed: PackedNet, pc: torch.Tensor, t4: torch.Tensor,
                             cls: torch.Tensor, g: torch.Tensor, got,
                             flat: Optional[torch.Tensor] = None, *, tol: float = 1e-4,
                             tie: float = 1e-5, max_tries: int = 256):
    """What an fp32 backward `got` = (d pc, d t4, d cls, d flat) is held to:
    K2's plain version run in float64 on the same fp32 inputs, with the relu
    ties resolved as `got` resolved them.

    A relu whose input lies within fp32 rounding of 0 (a tie) passes its
    gradient in one fp32 backward and not in another, since their sums run
    in other orders; either decision is right, and float64 makes one of
    them.  The units whose float64 input lies within `tie` * max(1, max
    |that relu's input|) of 0 are tried, closest to 0 first; the units of
    one relu that hold one value (copies: the attention's first relu takes
    its point-wise product repeated over the k slots) are one decision and
    are tried together.  A unit's other decision is kept when the change
    it makes to the gradients explains the difference left between `got`
    and the reference (a least-squares coefficient between 0.5 and 1.5) and
    moves some element by more than a tenth of its bound, `tol` * max(1,
    max |reference|) per gradient.  The search stops as soon as every
    element of `got` lies within its bound, or after `max_tries` decisions.

    Returns (the reference as float64 (d pc, d t4, d cls, d flat), the
    decisions changed as [(relu call, flat index, float64 input)])."""
    flat = packed.flat if flat is None else flat
    inputs = [t.detach().double() for t in (pc, t4, cls, flat)]
    g64 = g.detach().double()
    sizes = [t.numel() for t in inputs]

    def backward(flips):
        seen = []

        def relu(x):
            seen.append(x.detach())
            mask = x > 0
            idx = flips.get(len(seen) - 1)
            if idx:
                mask = mask.clone().view(-1)
                idx = torch.as_tensor(idx, device=x.device)
                mask[idx] = ~mask[idx]
                mask = mask.view(x.shape)
            return x * mask

        leaves = [t.clone().requires_grad_(True) for t in inputs]
        with torch.enable_grad():
            out = fused_forward_plain(None, packed, *leaves, relu=relu)
            grads = torch.autograd.grad(out, leaves, g64, allow_unused=True)
        grads = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]
        return torch.cat([d.reshape(-1) for d in grads]), seen

    ref, seen = backward({})
    bound = torch.cat([torch.full((n,), tol * max(1.0, float(r.abs().max())),
                                  dtype=ref.dtype, device=ref.device)
                       for n, r in zip(sizes, torch.split(ref, sizes))])
    diff = torch.cat([t.detach().reshape(-1).to(ref) for t in got]) - ref
    ties = []
    for i, x in enumerate(seen):
        x = x.reshape(-1)
        near = (x.abs() <= tie * max(1.0, float(x.abs().max()))).nonzero().reshape(-1)
        units = {}
        for j in near.tolist():
            units.setdefault(float(x[j]), []).append(j)
        ties += [(abs(v), i, js, v) for v, js in units.items()]
    flips, kept = {}, []
    for _, i, js, x in sorted(ties)[:max_tries]:
        if bool((diff.abs() <= bound).all()):
            break
        trial = {**flips, i: flips.get(i, []) + js}
        alt, _ = backward(trial)
        delta = alt - ref
        coef = float(diff @ delta) / max(float(delta @ delta), 1e-300)
        if 0.5 < coef < 1.5 and bool((delta.abs() > 0.1 * bound).any()):
            flips, ref, diff = trial, alt, diff - delta
            kept += [(i, j, x) for j in js]
    return tuple(r.view_as(t) for r, t in zip(torch.split(ref, sizes), inputs)), kept


class _FusedCore(torch.autograd.Function):
    """(pc, t4, cls, flat) -> out: K1 forward and K2 backward on the card;
    on the CPU the plain forward and autograd through it."""

    @staticmethod
    def forward(ctx, pc, t4, cls, flat, packed):
        ctx.packed = packed
        ctx.save_for_backward(pc, t4, cls, flat)
        if pc.device.type == "cpu":
            return fused_forward_plain(None, packed, pc, t4, cls, flat)
        if pc.device.type == "cuda":
            return fused_forward_cuda(packed, pc, t4, cls, flat)
        raise ValueError(f"no fused forward for device {pc.device}")

    @staticmethod
    def backward(ctx, g):
        pc, t4, cls, flat = ctx.saved_tensors
        if g.device.type == "cpu":
            grads = fused_backward_plain(ctx.packed, pc, t4, cls, g, flat)
        else:
            grads = fused_backward_cuda(ctx.packed, pc, t4, cls, g.contiguous(), flat)
        return (*grads, None)


def fused_forward(spec: Mapping, packed: PackedNet, pc: torch.Tensor,
                  t4: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """The fused forward: the plain version for CPU tensors, K1 for CUDA
    tensors (no fallback)."""
    if pc.device.type == "cpu":
        return fused_forward_plain(spec, packed, pc.float(), t4.float(), cls.float())
    if pc.device.type == "cuda":
        return fused_forward_cuda(packed, pc.float().contiguous(),
                                  t4.float().contiguous(), cls.float().contiguous())
    raise ValueError(f"no fused forward for device {pc.device}")


def make_fused_net_fn(config: Mapping[str, Any], net: ConditionalPointNet2,
                      n_points: int):
    """`(x, ts, label) -> eps` over `net`'s weights packed once, or None when
    the config is outside the fused scope (`scope_error`: e.g. npoint < N or
    K > N at this cloud size, or more points than the kernels hold).  The
    timestep and class embeddings run `net`'s own modules; the rest is
    `fused_forward`."""
    if scope_error(config, n_points) is not None:
        return None
    spec = build_spec(config, n_points)
    packed = pack_weights(net, spec)

    def net_fn(x, ts, label):
        with torch.no_grad():
            # fp32 whatever the activation dtype: the kernels keep their own
            t4 = net.t_embedder(ts).float()
            cls = net.class_emb(label.long())
            return fused_forward(spec, packed, x, t4, cls)

    net_fn.spec = spec
    net_fn.packed = packed
    return net_fn


def make_fused_train_fn(config: Mapping[str, Any], net: ConditionalPointNet2,
                        n_points: int):
    """The differentiable fused denoiser (counterpart: the JAX package's
    `make_fused_train_fn`): `apply(x, ts, label) -> eps` with gradients to
    every parameter of `net`, or None outside the fused scope.

    The timestep embedder and class embedding run as `net`'s modules under
    autograd; their gradients arrive through d(t4) and d(cls).  The weights
    reach the core through the packed buffer, built from the live
    parameters on every call (`PackedNet.live_flat`), so d(flat) flows back
    to each parameter by autograd.  The core is K1 + K2 on the card."""
    if scope_error(config, n_points) is not None:
        return None
    spec = build_spec(config, n_points)
    packed = pack_weights(net, spec)

    def apply(x, ts, label):
        t4 = net.t_embedder(ts)
        cls = net.class_emb(label.long())
        return _FusedCore.apply(x.float().contiguous(), t4.float().contiguous(),
                                cls.float().contiguous(), packed.live_flat(), packed)

    apply.spec = spec
    apply.packed = packed
    return apply
