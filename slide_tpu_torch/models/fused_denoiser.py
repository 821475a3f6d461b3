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
(counterpart: the TPU kernel `_pallas_backward`): it recomputes the forward
of each cloud, keeps every activation the backward needs in a per-cloud
tape (whose offsets are fields of the same table), and walks the layers in
reverse.  On the CPU the backward is autograd through `fused_forward_plain`,
recomputed inside `backward`: K2's plain version.  The clamps (distances at
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
N_BUFFERS = 5
N_GRAD_BUFFERS = 6          # K2's row-sized gradient buffers
STATS = 3 * MAX_GROUPS      # a GroupNorm's tape: mean, inverse std, var before the clip


# ---------------------------------------------------------------------------
# Config support check / spec (copies of the JAX package's, same semantics)


def supports_config(config: Mapping[str, Any]) -> bool:
    """True when `config` (a pointnet_config) is inside the fused kernel's
    architecture scope (see the module docstring)."""
    try:
        arch = config["architecture"]
        ok = (
            config["include_t"]
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
_NORM = (("s",), ("b",), ("c",), ("g",))         # c channels, g groups
# The fields after the weights are K2's tape: offsets into its per-cloud
# scratch of each activation the backward reads (z: a conv's output, a: after
# GroupNorm and relu, h: after the injection, st: the GroupNorm's STATS,
# out: the MLP's output after the residual; t/tn, u/un, v/vn: the attention's
# three GroupNorms' inputs and outputs, s its scores, w its softmax weights;
# x: a level's grouped rows, nf: a KnnFP level's [interp, skip, xyz]).
_MLP = (("n_layers",), ("inject_t",), ("inject_c",), ("res",),  # res 1: +x, 2: +res_conv(x)
        ("conv", _DENSE, MAX_LAYERS), ("norm", _NORM, MAX_LAYERS),
        ("fc_t", _DENSE), ("fc_c", _DENSE), ("res_conv", _DENSE),
        ("z", None, MAX_LAYERS), ("a", None, MAX_LAYERS), ("h", None, MAX_LAYERS),
        ("st", None, MAX_LAYERS), ("out",))
_ATT = (("feat_conv", _DENSE), ("grouped_conv", _DENSE), ("w_norm_1", _NORM),
        ("w_conv_1", _DENSE), ("w_norm_2", _NORM), ("w_conv_2", _DENSE),
        ("out_conv", _DENSE), ("out_norm", _NORM),
        ("t",), ("tn",), ("st1",), ("u",), ("st2",), ("un",), ("s",), ("v",),
        ("st3",), ("vn",), ("w",))
_SA = (("k",), ("mlp", _MLP), ("att", _ATT), ("x",))
_FP = (("k",), ("mlp1", _MLP), ("att", _ATT), ("mlp2", _MLP), ("x",), ("nf",))
TABLE = (("n",), ("din",), ("out_dim",), ("t4",), ("cls",), ("inc_abs",),
         ("inc_cen",), ("n_sa",), ("n_fp",), ("cloud_floats",), ("stats",), ("vec",),
         ("buf", None, N_BUFFERS), ("lvl", None, MAX_LEVELS + 1),
         ("sa", _SA, MAX_LEVELS), ("fp", _FP, MAX_LEVELS),
         ("head1", _DENSE), ("head_norm", _NORM), ("head_out", _DENSE),
         # K2: its per-cloud floats, the level features before the KnnFP
         # tower, the head's tape, and its gradient buffers
         ("bwd_floats",), ("flvl", None, MAX_LEVELS + 1),
         ("hin",), ("hz",), ("hst",), ("ha",),
         ("gbuf", None, N_GRAD_BUFFERS), ("gf", None, MAX_LEVELS + 1),
         ("gg", None, MAX_LEVELS + 1), ("gdist",), ("gxyz",), ("gvec",),
         ("gstat",), ("tvec",))


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
    walk; `layout` is the table read back (`decode_table`), which the plain
    version uses to find its weights.  `sources` lists, in buffer order, the
    parameters the buffer was packed from (`pack_flat` packs them again,
    differentiably, from the live parameters).  `scratch` / `bwd_scratch` are
    K1's and K2's per-cloud memory, grown to the largest batch seen and
    reused (launches on one stream never overlap)."""

    flat: torch.Tensor
    table: torch.Tensor
    layout: dict
    sources: list
    scratch: Optional[torch.Tensor] = None
    bwd_scratch: Optional[torch.Tensor] = None

    def scratch_for(self, batch: int) -> torch.Tensor:
        floats = batch * self.layout["cloud_floats"]
        if self.scratch is None or self.scratch.numel() < floats:
            self.scratch = torch.empty(floats, dtype=torch.float32,
                                       device=self.flat.device)
        return self.scratch

    def bwd_scratch_for(self, batch: int) -> torch.Tensor:
        floats = batch * self.layout["bwd_floats"]
        if self.bwd_scratch is None or self.bwd_scratch.numel() < floats:
            self.bwd_scratch = torch.empty(floats, dtype=torch.float32,
                                           device=self.flat.device)
        return self.bwd_scratch

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
    """Every sub-record of a table record whose fields are `keys`."""
    if isinstance(rec, dict):
        if set(rec) == keys:
            yield rec
            return
        for v in rec.values():
            yield from _records(v, keys)
    elif isinstance(rec, list):
        for v in rec:
            yield from _records(v, keys)


def _tape_layout(rec: dict, n: int, cmax: int) -> None:
    """K2's per-cloud scratch: give every tape and gradient field of `rec`
    its offset (each tensor 32-float aligned) and set `bwd_floats`."""
    pos = 0

    def take(floats: int) -> int:
        nonlocal pos
        off = pos
        pos += -(-floats // 32) * 32
        return off

    def mlp(m, rows):
        for i in range(m["n_layers"]):
            width = m["conv"][i]["cout"]
            m.setdefault("z", []).append(take(rows * width))
            m.setdefault("a", []).append(take(rows * width))
            m.setdefault("h", []).append(take(rows * width))
            m.setdefault("st", []).append(take(STATS))
        m["out"] = take(rows * m["conv"][m["n_layers"] - 1]["cout"])

    def att(a, rows):
        ct = a["w_conv_1"]["cin"]
        inter, co = a["w_conv_1"]["cout"], a["w_conv_2"]["cout"]
        for key, floats in (("t", rows * ct), ("tn", rows * ct), ("st1", STATS),
                            ("u", rows * inter), ("st2", STATS), ("un", rows * inter),
                            ("s", rows * co), ("v", rows * co), ("st3", STATS),
                            ("vn", rows * co), ("w", rows * co)):
            a[key] = take(floats)

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
    rec["flvl"] = [take(n * cmax) for _ in range(MAX_LEVELS + 1)]
    rec["hin"] = take(n * rec["head1"]["cin"])
    rec["hz"] = take(n * rec["head1"]["cout"])
    rec["hst"] = take(STATS)
    rec["ha"] = take(n * rec["head1"]["cout"])
    rec["gbuf"] = [take(rmax * cmax) for _ in range(N_GRAD_BUFFERS)]
    rec["gf"] = [take(n * cmax) for _ in range(MAX_LEVELS + 1)]
    rec["gg"] = [take(n * cmax) for _ in range(MAX_LEVELS + 1)]
    rec["gdist"] = take(n * n)
    rec["gxyz"] = take(n * 3)
    rec["gvec"] = take(rec["t4"] + rec["cls"])
    rec["gstat"] = take(2 * MAX_GROUPS)
    rec["tvec"] = take(MAX_VEC)
    rec["bwd_floats"] = pos


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
    # K1's per-cloud scratch: five (rows x cmax) buffers, the level features,
    # the GroupNorm statistics (mean and inverse std of up to 32 groups) and
    # the injection vector
    rmax = n * max([1] + [s["k"] for s in spec["sa"] + spec["fp"]])
    big = -(-rmax * cmax // 32) * 32
    lvl = -(-n * cmax // 32) * 32
    rec["buf"] = [i * big for i in range(N_BUFFERS)]
    rec["lvl"] = [N_BUFFERS * big + i * lvl for i in range(MAX_LEVELS + 1)]
    rec["stats"] = N_BUFFERS * big + (MAX_LEVELS + 1) * lvl
    rec["vec"] = rec["stats"] + 2 * MAX_GROUPS
    rec["cloud_floats"] = rec["vec"] + MAX_VEC
    _tape_layout(rec, n, cmax)

    ints = encode_table(TABLE, rec)
    dev = net.head_conv1.weight.device
    with torch.no_grad():
        flat = pack_flat(p.sources).to(dev).contiguous()
    table = torch.tensor(ints, dtype=torch.int32, device=dev)
    layout, _ = decode_table(TABLE, ints)
    return PackedNet(flat=flat, table=table, layout=layout, sources=p.sources)


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
    return lib


def _io_shapes(lay: Mapping, b: int) -> dict:
    return {"pc": (b, lay["n"], lay["din"]), "t4": (b, lay["t4"]), "cls": (b, lay["cls"]),
            "g": (b, lay["n"], lay["out_dim"])}


def fused_forward_cuda(packed: PackedNet, pc: torch.Tensor, t4: torch.Tensor,
                       cls: torch.Tensor, flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 (`csrc/fused_denoiser.cu`), one cluster of blocks per cloud,
    over the weights `flat` (laid out as `packed.flat`, which is the default).
    Takes contiguous fp32 CUDA tensors of the packed net's widths; raises on
    anything else."""
    lay = packed.layout
    flat = packed.flat if flat is None else flat
    b = pc.shape[0]
    if b == 0:
        raise ValueError("fused_forward_cuda: empty batch")
    shapes = {**_io_shapes(lay, b), "weights": tuple(packed.flat.shape)}
    _check_cuda("fused_forward_cuda", packed,
                {"pc": pc, "t4": t4, "cls": cls, "weights": flat}, shapes)
    dev = pc.device
    lib = _load_checked(packed)
    out = torch.empty((b, lay["n"], lay["out_dim"]), dtype=torch.float32, device=dev)
    scratch = packed.scratch_for(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slide_fused_denoiser(pc.data_ptr(), t4.data_ptr(), cls.data_ptr(),
                                    flat.data_ptr(), packed.table.data_ptr(),
                                    scratch.data_ptr(), out.data_ptr(), b,
                                    dev.index, stream)
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
    Takes contiguous fp32 CUDA tensors; raises on anything else."""
    lay = packed.layout
    flat = packed.flat if flat is None else flat
    b = pc.shape[0]
    if b == 0:
        raise ValueError("fused_backward_cuda: empty batch")
    shapes = {**_io_shapes(lay, b), "weights": tuple(packed.flat.shape)}
    _check_cuda("fused_backward_cuda", packed,
                {"pc": pc, "t4": t4, "cls": cls, "g": g, "weights": flat}, shapes)
    dev = pc.device
    lib = _load_checked(packed)
    size = flat.numel()
    partial = torch.zeros((b, size), dtype=torch.float32, device=dev)
    dpc, dt4, dcls = torch.empty_like(pc), torch.empty_like(t4), torch.empty_like(cls)
    dflat = torch.empty_like(flat)
    scratch = packed.bwd_scratch_for(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slide_fused_denoiser_bwd(
        pc.data_ptr(), t4.data_ptr(), cls.data_ptr(), g.data_ptr(), flat.data_ptr(),
        packed.table.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
        dpc.data_ptr(), dt4.data_ptr(), dcls.data_ptr(), dflat.data_ptr(), b, size,
        dev.index, stream)
    _build.check(lib, code, "fused_denoiser_bwd")
    _build.launch_counts["fused_denoiser_bwd"] += 1
    return dpc, dt4, dcls, dflat


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
    |that relu's input|) of 0 are tried, closest to 0 first.  A unit's
    other decision is kept when the change it makes to the gradients
    explains the difference left between `got` and the reference (a
    least-squares coefficient between 0.5 and 1.5) and moves some element
    by more than a tenth of its bound, `tol` * max(1, max |reference|) per
    gradient.  The search stops as soon as every element of `got` lies
    within its bound, or after `max_tries` units.

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
        ties += [(abs(float(x[j])), i, int(j), float(x[j])) for j in near.tolist()]
    flips, kept = {}, []
    for _, i, j, x in sorted(ties)[:max_tries]:
        if bool((diff.abs() <= bound).all()):
            break
        trial = {**flips, i: flips.get(i, []) + [j]}
        alt, _ = backward(trial)
        delta = alt - ref
        coef = float(diff @ delta) / max(float(delta @ delta), 1e-300)
        if 0.5 < coef < 1.5 and bool((delta.abs() > 0.1 * bound).any()):
            flips, ref, diff = trial, alt, diff - delta
            kept.append((i, j, x))
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
            t4 = net.t_embedder(ts)
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
