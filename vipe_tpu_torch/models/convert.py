"""Flax → PyTorch weight conversion for DroidNet, GeoCalib, UniDepth, Depth
Anything v2 and Video Depth Anything.

``droidnet_state_dict_from_flax``, ``geocalib_state_dict_from_flax``,
``unidepth_state_dict_from_flax``, ``dav2_state_dict_from_flax`` and
``vda_state_dict_from_flax`` are the inverses of
``vipe_tpu.models.convert.convert_droidnet``, ``convert_geocalib``,
``convert_unidepth``, ``convert_dav2`` and ``convert_vda``: they turn the
JAX package's param trees (given as numpy arrays) into this port's state
dicts, in ViPE's key layout, so both packages can run the same weights.
Conv kernels go from flax ``(kh, kw, I, O)`` to torch ``(O, I, kh, kw)``.
"""

from __future__ import annotations

import numpy as np
import torch

# flax UpdateModule entry → torch module path
_UPDATE = {
    "corr_enc1": "update.corr_encoder.0",
    "corr_enc2": "update.corr_encoder.2",
    "flow_enc1": "update.flow_encoder.0",
    "flow_enc2": "update.flow_encoder.2",
    "weight1": "update.weight.0",
    "weight2": "update.weight.2",
    "delta1": "update.delta.0",
    "delta2": "update.delta.2",
}
_AGG = {"conv1": "update.agg.conv1", "conv2": "update.agg.conv2", "eta": "update.agg.eta.0"}
_GRU = ("convz", "convr", "convq", "w", "convz_glo", "convr_glo", "convq_glo")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _put(sd: dict, key: str, entry: dict):
    """A conv; its bias is optional (GeoCalib's ``out_conv`` has none)."""
    k = np.asarray(entry["kernel"], np.float32)
    sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    if "bias" in entry:
        sd[f"{key}.bias"] = _tensor(entry["bias"])


def _encoder(sd: dict, prefix: str, tree: dict):
    _put(sd, f"{prefix}.conv1", tree["conv1"])
    for stage in (1, 2, 3):
        for blk in (0, 1):
            t = tree[f"layer{stage}_{blk}"]
            p = f"{prefix}.layer{stage}.{blk}"
            _put(sd, f"{p}.conv1", t["conv1"])
            _put(sd, f"{p}.conv2", t["conv2"])
            if "downsample" in t:
                _put(sd, f"{p}.downsample.0", t["downsample"])
    _put(sd, f"{prefix}.conv2", tree["conv2"])


def droidnet_state_dict_from_flax(params) -> dict:
    """``{"params": {"fnet", "cnet", "update"}}`` (numpy leaves) → the
    port's ``DroidNet`` state dict (f32 tensors)."""
    p = params["params"] if "params" in params else params
    sd: dict = {}
    _encoder(sd, "fnet", p["fnet"])
    _encoder(sd, "cnet", p["cnet"])
    upd = p["update"]
    for name, key in _UPDATE.items():
        _put(sd, key, upd[name])
    for name in _GRU:
        _put(sd, f"update.gru.{name}", upd["gru"][name])
    for name, key in _AGG.items():
        _put(sd, key, upd["agg"][name])
    return sd


def _put_norm(sd: dict, key: str, params: dict, stats=None):
    """LayerNorm (``stats`` None) or BatchNorm (running statistics)."""
    sd[f"{key}.weight"] = _tensor(params["scale"])
    sd[f"{key}.bias"] = _tensor(params["bias"])
    if stats is not None:
        sd[f"{key}.running_mean"] = _tensor(stats["mean"])
        sd[f"{key}.running_var"] = _tensor(stats["var"])


_GATE = ("conv0", "conv0_1", "conv0_2", "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3")


def _ham_head(sd: dict, prefix: str, p: dict):
    for name in ("squeeze", "align", "out_conv"):
        _put(sd, f"{prefix}.{name}.conv", p[name]["conv"])
    for name in ("ham_in", "ham_out"):
        _put(sd, f"{prefix}.hamburger.{name}.conv", p["hamburger"][name]["conv"])
    for unit in (1, 2):
        for conv in ("conv1", "conv2"):
            _put(sd, f"{prefix}.ll_fusion.resConfUnit{unit}.{conv}",
                      p[f"ll_rcu{unit}"][conv])
    _put(sd, f"{prefix}.linear_pred_uncertainty.0.conv", p["unc_conv"]["conv"])
    _put(sd, f"{prefix}.linear_pred_uncertainty.1", p["unc_pred"])


def geocalib_state_dict_from_flax(variables) -> dict:
    """``{"params", "batch_stats"}`` of ``vipe_tpu``'s ``GeoCalibNet``
    (numpy leaves) → the port's ``GeoCalibNet`` state dict (f32 tensors)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    bp, bs = p["backbone"], s["backbone"]
    bb = "backbone"
    _put(sd, f"{bb}.patch_embed1.proj.0", bp["stem_conv1"])
    _put_norm(sd, f"{bb}.patch_embed1.proj.1", bp["stem_bn1"], bs["stem_bn1"])
    _put(sd, f"{bb}.patch_embed1.proj.3", bp["stem_conv2"])
    _put_norm(sd, f"{bb}.patch_embed1.proj.4", bp["stem_bn2"], bs["stem_bn2"])
    for i, depth in enumerate((3, 3, 12, 3)):
        if i > 0:
            _put(sd, f"{bb}.patch_embed{i + 1}.proj", bp[f"patch_embed{i + 1}"])
            _put_norm(sd, f"{bb}.patch_embed{i + 1}.norm", bp[f"patch_bn{i + 1}"],
                      bs[f"patch_bn{i + 1}"])
        for j in range(depth):
            b, bpj, bsj = f"{bb}.block{i + 1}.{j}", bp[f"stage{i + 1}_block{j}"], \
                bs[f"stage{i + 1}_block{j}"]
            sd[f"{b}.layer_scale_1"] = _tensor(bpj["layer_scale_1"])
            sd[f"{b}.layer_scale_2"] = _tensor(bpj["layer_scale_2"])
            _put_norm(sd, f"{b}.norm1", bpj["norm1"], bsj["norm1"])
            _put_norm(sd, f"{b}.norm2", bpj["norm2"], bsj["norm2"])
            _put(sd, f"{b}.attn.proj_1", bpj["attn_proj1"])
            _put(sd, f"{b}.attn.proj_2", bpj["attn_proj2"])
            for name in _GATE:
                _put(sd, f"{b}.attn.spatial_gating_unit.{name}", bpj["attn_gate"][name])
            _put(sd, f"{b}.mlp.fc1", bpj["mlp"]["fc1"])
            _put(sd, f"{b}.mlp.dwconv.dwconv", bpj["mlp"]["dwconv"]["dwconv"])
            _put(sd, f"{b}.mlp.fc2", bpj["mlp"]["fc2"])
        _put_norm(sd, f"{bb}.norm{i + 1}", bp[f"norm{i + 1}"])
    _put(sd, "ll_enc.conv1.conv", p["ll_conv1"]["conv"])
    _put(sd, "ll_enc.conv2.conv", p["ll_conv2"]["conv"])
    pd = "perspective_decoder"
    _ham_head(sd, f"{pd}.up_head.decoder", p["up_decoder"])
    _put(sd, f"{pd}.up_head.linear_pred_up", p["linear_pred_up"])
    _ham_head(sd, f"{pd}.latitude_head.decoder", p["lat_decoder"])
    _put(sd, f"{pd}.latitude_head.linear_pred_latitude", p["linear_pred_latitude"])
    return sd


def _put_linear(sd: dict, key: str, entry: dict):
    """A dense layer: flax ``(in, out)`` kernel → torch ``(out, in)``; the
    bias is optional (UniDepth's attention projections have none)."""
    sd[f"{key}.weight"] = _tensor(np.asarray(entry["kernel"], np.float32).T)
    if "bias" in entry:
        sd[f"{key}.bias"] = _tensor(entry["bias"])


def _put_conv_transpose(sd: dict, key: str, entry: dict):
    """flax ``ConvTranspose`` (kh, kw, I, O) → torch ``ConvTranspose2d``
    (I, O, kh, kw), spatially flipped back (the JAX converter flips it)."""
    k = np.asarray(entry["kernel"], np.float32).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[f"{key}.weight"] = torch.from_numpy(k.copy())
    sd[f"{key}.bias"] = _tensor(entry["bias"])


def vit_state_dict_from_flax(params, prefix: str = "") -> dict:
    """``vipe_tpu``'s ``DinoViT`` params → the port's ``DinoViT`` state dict,
    its keys under ``prefix`` (inverse of ``convert_dinov2_vit``)."""
    p = params["params"] if "params" in params else params
    sd: dict = {}
    pf = f"{prefix}." if prefix else ""
    _put(sd, f"{pf}patch_embed.proj", p["patch_embed"])
    if "alpha_proj" in p:
        _put(sd, f"{pf}patch_embed.alpha_proj", p["alpha_proj"])
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in p:
            sd[f"{pf}{name}"] = _tensor(p[name])
    _put_norm(sd, f"{pf}norm", p["norm"])
    i = 0
    while f"block{i}" in p:
        b, pb = f"{pf}blocks.{i}", p[f"block{i}"]
        _put_norm(sd, f"{b}.norm1", pb["norm1"])
        _put_linear(sd, f"{b}.attn.qkv", pb["attn"]["qkv"])
        _put_linear(sd, f"{b}.attn.proj", pb["attn"]["proj"])
        sd[f"{b}.ls1.gamma"] = _tensor(pb["ls1"]["gamma"])
        _put_norm(sd, f"{b}.norm2", pb["norm2"])
        _put_linear(sd, f"{b}.mlp.fc1", pb["mlp"]["fc1"])
        _put_linear(sd, f"{b}.mlp.fc2", pb["mlp"]["fc2"])
        sd[f"{b}.ls2.gamma"] = _tensor(pb["ls2"]["gamma"])
        i += 1
    return sd


def _put_mlp_ud(sd: dict, key: str, p: dict):
    _put_norm(sd, f"{key}.norm", p["norm"])
    _put_linear(sd, f"{key}.proj1", p["proj1"])
    _put_linear(sd, f"{key}.proj2", p["proj2"])


def _put_attn_ud(sd: dict, key: str, p: dict):
    for name in ("norm_attnx", "norm_attnctx"):
        _put_norm(sd, f"{key}.{name}", p[name])
    for name in ("kv", "q", "out"):
        _put_linear(sd, f"{key}.{name}", p[name])
    if "ls1_gamma" in p:
        sd[f"{key}.ls1.gamma"] = _tensor(p["ls1_gamma"])
        sd[f"{key}.ls2.gamma"] = _tensor(p["ls2_gamma"])
    _put_mlp_ud(sd, f"{key}.mlp", p["mlp"])


def unidepth_state_dict_from_flax(params) -> dict:
    """``{"vit", "decoder"}`` of ``vipe_tpu``'s ``UniDepthNet`` (numpy
    leaves) → the port's ``UniDepthNet`` state dict (inverse of
    ``convert_unidepth``)."""
    sd = vit_state_dict_from_flax(params["vit"], "pixel_encoder")
    p = params["decoder"]["params"]
    d = "pixel_decoder"
    i = 0
    while f"input_adapter{i}" in p:
        _put_linear(sd, f"{d}.input_adapter.input_adapters.{i}", p[f"input_adapter{i}"])
        _put_linear(sd, f"{d}.camera_token_adapter.input_adapters.{i}",
                    p[f"camera_token_adapter{i}"])
        i += 1
    cam, cl = p["camera_layer"], f"{d}.camera_layer"
    sd[f"{cl}.latents_pos"] = _tensor(cam["latents_pos"])
    _put_mlp_ud(sd, f"{cl}.project", cam["project"])
    _put_attn_ud(sd, f"{cl}.aggregate1", cam["aggregate1"])
    _put_attn_ud(sd, f"{cl}.aggregate2", cam["aggregate2"])
    _put_mlp_ud(sd, f"{cl}.out_pinhole", cam["out_pinhole"])

    dp, dl = p["depth_layer"], f"{d}.depth_layer"
    _put_linear(sd, f"{dl}.to_latents", dp["to_latents"])
    lvl = 0
    while f"prompt_camera{lvl}" in dp:
        _put_attn_ud(sd, f"{dl}.prompt_camera.{lvl}.layers.0", dp[f"prompt_camera{lvl}"]["block0"])
        lvl += 1
    stage = 0
    while f"process_features{stage}" in dp:
        _put_conv_transpose(sd, f"{dl}.process_features.{stage}", dp[f"process_features{stage}"])
        ups = dp[f"ups{stage}"]
        j = 0
        while f"rcu{j}" in ups:
            u = f"{dl}.ups.{stage}.convs.{j}"
            _put(sd, f"{u}.conv1", ups[f"rcu{j}"]["conv1"])
            _put(sd, f"{u}.conv2", ups[f"rcu{j}"]["conv2"])
            sd[f"{u}.gamma"] = _tensor(ups[f"rcu{j}"]["gamma"]).reshape(1, -1, 1, 1)
            j += 1
        _put(sd, f"{dl}.ups.{stage}.up.0", ups["up_conv"])
        stage += 1
    last = stage - 1
    for head, mlp in (("depth", f"depth_mlp.{last}"), ("confidence", "confidence_mlp")):
        _put_norm(sd, f"{dl}.{mlp}.0", dp[f"{head}_mlp_norm"])
        _put_linear(sd, f"{dl}.{mlp}.1", dp[f"{head}_mlp_lin"])
        _put(sd, f"{dl}.to_{head}_lr", dp[f"to_{head}_lr"])
        _put(sd, f"{dl}.to_{head}_hr.0", dp[f"to_{head}_hr0"])
        _put(sd, f"{dl}.to_{head}_hr.2", dp[f"to_{head}_hr2"])
    return sd


def _dpt_head_from_flax(sd: dict, prefix: str, p: dict):
    for i in range(4):
        _put(sd, f"{prefix}.projects.{i}", p[f"project{i}"])
        _put(sd, f"{prefix}.scratch.layer{i + 1}_rn", p[f"layer{i + 1}_rn"])
    _put_conv_transpose(sd, f"{prefix}.resize_layers.0", p["resize0"])
    _put_conv_transpose(sd, f"{prefix}.resize_layers.1", p["resize1"])
    _put(sd, f"{prefix}.resize_layers.3", p["resize3"])
    for r in range(1, 5):
        rn, key = p[f"refinenet{r}"], f"{prefix}.scratch.refinenet{r}"
        for unit in (1, 2):
            if f"rcu{unit}" in rn:
                _put(sd, f"{key}.resConfUnit{unit}.conv1", rn[f"rcu{unit}"]["conv1"])
                _put(sd, f"{key}.resConfUnit{unit}.conv2", rn[f"rcu{unit}"]["conv2"])
        _put(sd, f"{key}.out_conv", rn["out_conv"])
    _put(sd, f"{prefix}.scratch.output_conv1", p["output_conv1"])
    _put(sd, f"{prefix}.scratch.output_conv2.0", p["output_conv2_0"])
    _put(sd, f"{prefix}.scratch.output_conv2.2", p["output_conv2_2"])


def dav2_state_dict_from_flax(params) -> dict:
    """``{"vit", "head"}`` of ``vipe_tpu``'s ``DepthAnythingV2Net`` (numpy
    leaves; a conditioned ViT's ``alpha_proj`` too) → the port's
    ``DepthAnythingV2Net`` state dict (inverse of ``convert_dav2``)."""
    sd = vit_state_dict_from_flax(params["vit"], "pretrained")
    _dpt_head_from_flax(sd, "depth_head", params["head"]["params"])
    return sd


def _motion_from_flax(sd: dict, key: str, p: dict):
    t = f"{key}.temporal_transformer"
    _put_norm(sd, f"{t}.norm", p["norm"])
    _put_linear(sd, f"{t}.proj_in", p["proj_in"])
    _put_linear(sd, f"{t}.proj_out", p["proj_out"])
    li = 0
    while f"block{li}" in p:
        pb, b = p[f"block{li}"], f"{t}.transformer_blocks.{li}"
        ai = 0
        while f"attn{ai}" in pb:
            a = f"{b}.attention_blocks.{ai}"
            for name in ("to_q", "to_k", "to_v"):
                _put_linear(sd, f"{a}.{name}", pb[f"attn{ai}"][name])
            _put_linear(sd, f"{a}.to_out.0", pb[f"attn{ai}"]["to_out"])
            _put_norm(sd, f"{b}.norms.{ai}", pb[f"norm{ai}"])
            ai += 1
        _put_norm(sd, f"{b}.ff_norm", pb["ff_norm"])
        _put_linear(sd, f"{b}.ff.net.0.proj", pb["ff_geglu"]["proj"])
        _put_linear(sd, f"{b}.ff.net.2", pb["ff_out"])
        li += 1


def vda_state_dict_from_flax(params) -> dict:
    """``{"vit", "head"}`` of ``vipe_tpu``'s ``VideoDepthAnythingNet`` (numpy
    leaves) → the port's ``VideoDepthAnythingNet`` state dict (inverse of
    ``convert_vda``)."""
    sd = vit_state_dict_from_flax(params["vit"], "pretrained")
    p = params["head"]["params"]
    _dpt_head_from_flax(sd, "head", p)
    for m in range(4):
        _motion_from_flax(sd, f"head.motion_modules.{m}", p[f"motion{m}"])
    return sd
