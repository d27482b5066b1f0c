"""Flax → PyTorch weight conversion for DroidNet, GeoCalib, UniDepth, Depth
Anything v2, Video Depth Anything, Metric3D v2, SAM, GroundingDINO and
DeAOT.

``droidnet_state_dict_from_flax``, ``geocalib_state_dict_from_flax``,
``unidepth_state_dict_from_flax``, ``dav2_state_dict_from_flax``,
``vda_state_dict_from_flax``, ``metric3d_state_dict_from_flax`` and
``sam_state_dict_from_flax`` are the inverses of
``vipe_tpu.models.convert.convert_droidnet``, ``convert_geocalib``,
``convert_unidepth``, ``convert_dav2``, ``convert_vda``,
``convert_metric3d`` and ``convert_sam``; ``gdino_state_dict_from_flax`` and
``deaot_state_dict_from_flax`` those of the track_anything packages'
``convert_gdino`` and ``convert_deaot``.  They turn the
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


def metric3d_state_dict_from_flax(params) -> dict:
    """``{"vit", "decoder"}`` of ``vipe_tpu``'s ``Metric3DNet`` (numpy
    leaves) → the port's ``Metric3DNet`` state dict, ViPE's layout
    (inverse of ``convert_metric3d``)."""
    sd = vit_state_dict_from_flax(params["vit"], "depth_model.encoder")
    p = params["decoder"]["params"]
    d = "depth_model.decoder"
    for i in range(4):
        r, pr = f"{d}.token2feature.read_{i}", p[f"read_{i}"]
        _put_linear(sd, f"{r}.readoper.project_patch", pr["readoper"]["project_patch"])
        _put_linear(sd, f"{r}.readoper.project_learn", pr["readoper"]["project_learn"])
    _put_conv_transpose(sd, f"{d}.token2feature.read_1.sample", p["read_1"]["sample"])
    _put(sd, f"{d}.token2feature.read_0.sample.0", p["read_0"]["sample"])
    for name in ("upconv_3", "upconv_2", "upconv_1"):
        u, pu = f"{d}.decoder_mono.{name}", p[name]
        for way in ("way_trunk", "way_branch"):
            if way in pu:
                _put(sd, f"{u}.{way}.conv1", pu[way]["conv1"])
                _put(sd, f"{u}.{way}.conv2", pu[way]["conv2"])
        _put(sd, f"{u}.out_conv", pu["out_conv"])
    for k in (0, 2):
        _put(sd, f"{d}.depth_regressor.{k}", p[f"depth_regressor_{k}"])
    for k in (0, 2, 4, 6):
        _put(sd, f"{d}.normal_predictor.{k}", p[f"normal_predictor_{k}"])
    for lvl, tag in enumerate(("04", "08", "16")):
        for j in (0, 1):
            c, pc = f"{d}.context_feature_encoder.outputs{tag}.{j}", p[f"outputs{tag}_{j}"]
            res = pc["res"]
            for name in ("conv1", "conv2"):
                _put(sd, f"{c}.0.{name}", res[name])
            for name in ("norm1", "norm2"):
                _put_norm(sd, f"{c}.0.{name}", res[name])
            if "downsample" in res:
                _put(sd, f"{c}.0.downsample.0", res["downsample"])
                _put_norm(sd, f"{c}.0.norm3", res["norm3"])
            _put(sd, f"{c}.1", pc["conv"])
        _put(sd, f"{d}.context_zqr_convs.{lvl}", p[f"context_zqr_convs_{lvl}"])
    ub, pub = f"{d}.update_block", p["update_block"]
    for g in ("gru08", "gru16", "gru32"):
        for name in ("convz", "convr", "convq"):
            _put(sd, f"{ub}.{g}.{name}", pub[g][name])
    for name in ("conv1d", "conv2d", "conv1n", "conv2n"):
        _put(sd, f"{ub}.flow_head.{name}", pub["flow_head"][name])
    _put(sd, f"{ub}.mask.0", pub["mask0"])
    _put(sd, f"{ub}.mask.2", pub["mask2"])
    return sd


# ------------------------------------------------------------ TrackAnything


def _put_mlp(sd: dict, key: str, p: dict):
    j = 0
    while f"layers_{j}" in p:
        _put_linear(sd, f"{key}.layers.{j}", p[f"layers_{j}"])
        j += 1


def sam_state_dict_from_flax(params) -> dict:
    """``{"encoder", "prompt", "decoder", "mask_prompt"}`` of ``vipe_tpu``'s
    ``SamPredictor`` (numpy leaves) → the port's ``Sam`` state dict, Meta's
    key layout (inverse of ``convert_sam``)."""
    enc = params["encoder"]["params"]
    sd: dict = {}
    e = "image_encoder"
    _put(sd, f"{e}.patch_embed.proj", enc["patch_embed"])
    sd[f"{e}.pos_embed"] = _tensor(enc["pos_embed"])
    i = 0
    while f"block{i}" in enc:
        b, pb = f"{e}.blocks.{i}", enc[f"block{i}"]
        _put_norm(sd, f"{b}.norm1", pb["norm1"])
        _put_linear(sd, f"{b}.attn.qkv", pb["attn"]["qkv"])
        _put_linear(sd, f"{b}.attn.proj", pb["attn"]["proj"])
        sd[f"{b}.attn.rel_pos_h"] = _tensor(pb["attn"]["rel_pos_h"])
        sd[f"{b}.attn.rel_pos_w"] = _tensor(pb["attn"]["rel_pos_w"])
        _put_norm(sd, f"{b}.norm2", pb["norm2"])
        _put_linear(sd, f"{b}.mlp.lin1", pb["mlp_lin1"])
        _put_linear(sd, f"{b}.mlp.lin2", pb["mlp_lin2"])
        i += 1
    for j, name in enumerate(("neck_conv1", "neck_ln1", "neck_conv2", "neck_ln2")):
        (_put if "conv" in name else _put_norm)(sd, f"{e}.neck.{j}", enc[name])

    pr, pp = "prompt_encoder", params["prompt"]["params"]
    sd[f"{pr}.pe_layer.positional_encoding_gaussian_matrix"] = _tensor(pp["pe_gaussian"])
    for k in (2, 3):
        sd[f"{pr}.point_embeddings.{k}.weight"] = _tensor(pp[f"point_embed_{k}"])[None]
    sd[f"{pr}.no_mask_embed.weight"] = _tensor(pp["no_mask_embed"])[None]
    mp = params["mask_prompt"]["params"]
    for j, name in ((0, "conv1"), (1, "ln1"), (3, "conv2"), (4, "ln2"), (6, "conv3")):
        (_put if "conv" in name else _put_norm)(sd, f"{pr}.mask_downscaling.{j}", mp[name])

    d, dec = "mask_decoder", params["decoder"]["params"]
    sd[f"{d}.iou_token.weight"] = _tensor(dec["iou_token"])
    sd[f"{d}.mask_tokens.weight"] = _tensor(dec["mask_tokens"])

    def attn(key, p):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put_linear(sd, f"{key}.{name}", p[name])

    for i in range(2):
        b, pb = f"{d}.transformer.layers.{i}", dec[f"layer{i}"]
        attn(f"{b}.self_attn", pb["self_attn"])
        attn(f"{b}.cross_attn_token_to_image", pb["cross_attn_t2i"])
        attn(f"{b}.cross_attn_image_to_token", pb["cross_attn_i2t"])
        for n in (1, 2, 3, 4):
            _put_norm(sd, f"{b}.norm{n}", pb[f"norm{n}"])
        _put_linear(sd, f"{b}.mlp.lin1", pb["mlp_lin1"])
        _put_linear(sd, f"{b}.mlp.lin2", pb["mlp_lin2"])
    attn(f"{d}.transformer.final_attn_token_to_image", dec["final_attn"])
    _put_norm(sd, f"{d}.transformer.norm_final_attn", dec["norm_final"])
    _put_conv_transpose(sd, f"{d}.output_upscaling.0", dec["upscale1"])
    _put_norm(sd, f"{d}.output_upscaling.1", dec["upscale_ln"])
    _put_conv_transpose(sd, f"{d}.output_upscaling.3", dec["upscale2"])
    for k in range(4):
        for j in range(3):
            _put_linear(sd, f"{d}.output_hypernetworks_mlps.{k}.layers.{j}",
                        dec[f"hyper{k}_lin{j}"])
    for j in range(3):
        _put_linear(sd, f"{d}.iou_prediction_head.layers.{j}", dec[f"iou_lin{j}"])
    return sd


def _put_mha(sd: dict, key: str, p: dict):
    """q/k/v Dense → ``nn.MultiheadAttention``'s packed ``in_proj``."""
    sd[f"{key}.in_proj_weight"] = _tensor(np.concatenate(
        [np.asarray(p[n]["kernel"], np.float32).T for n in ("q_proj", "k_proj", "v_proj")]))
    sd[f"{key}.in_proj_bias"] = _tensor(np.concatenate(
        [np.asarray(p[n]["bias"], np.float32) for n in ("q_proj", "k_proj", "v_proj")]))
    _put_linear(sd, f"{key}.out_proj", p["out_proj"])


def _put_all_linear(sd: dict, key: str, p: dict, names):
    for name in names:
        _put_linear(sd, f"{key}.{name}", p[name])


_MSDEFORM = ("sampling_offsets", "attention_weights", "value_proj", "output_proj")


def gdino_state_dict_from_flax(params) -> dict:
    """``vipe_tpu``'s ``GroundingDINOModel`` params (numpy leaves) → the
    port's state dict, the reference's key layout (inverse of
    ``convert_gdino``)."""
    p = params["params"] if "params" in params else params
    sd: dict = {}
    bb, pb = "backbone.0", p["backbone"]
    _put(sd, f"{bb}.patch_embed.proj", pb["patch_embed_proj"])
    _put_norm(sd, f"{bb}.patch_embed.norm", pb["patch_embed_norm"])
    i = 0
    while f"layers_{i}_blocks_0" in pb:
        b = 0
        while f"layers_{i}_blocks_{b}" in pb:
            k, q = f"{bb}.layers.{i}.blocks.{b}", pb[f"layers_{i}_blocks_{b}"]
            _put_norm(sd, f"{k}.norm1", q["norm1"])
            _put_norm(sd, f"{k}.norm2", q["norm2"])
            _put_all_linear(sd, f"{k}.attn", q["attn"], ("qkv", "proj"))
            sd[f"{k}.attn.relative_position_bias_table"] = _tensor(
                q["attn"]["relative_position_bias_table"])
            _put_all_linear(sd, f"{k}.mlp", q["mlp"], ("fc1", "fc2"))
            b += 1
        if f"layers_{i}_downsample" in pb:
            q = pb[f"layers_{i}_downsample"]
            _put_norm(sd, f"{bb}.layers.{i}.downsample.norm", q["norm"])
            _put_linear(sd, f"{bb}.layers.{i}.downsample.reduction", q["reduction"])
        i += 1
    for i in (1, 2, 3):
        _put_norm(sd, f"{bb}.norm{i}", pb[f"out_norm{i}"])

    pt = p["bert"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"bert.embeddings.{name}.weight"] = _tensor(pt[name])
    _put_norm(sd, "bert.embeddings.LayerNorm", pt["embeddings_norm"])
    i = 0
    while f"layer_{i}" in pt:
        k, q = f"bert.encoder.layer.{i}", pt[f"layer_{i}"]
        _put_all_linear(sd, f"{k}.attention.self", q["attention_self"], ("query", "key", "value"))
        _put_linear(sd, f"{k}.attention.output.dense", q["attention_output_dense"])
        _put_norm(sd, f"{k}.attention.output.LayerNorm", q["attention_output_norm"])
        _put_linear(sd, f"{k}.intermediate.dense", q["intermediate_dense"])
        _put_linear(sd, f"{k}.output.dense", q["output_dense"])
        _put_norm(sd, f"{k}.output.LayerNorm", q["output_norm"])
        i += 1
    _put_linear(sd, "feat_map", p["feat_map"])

    i = 0
    while f"input_proj_{i}" in p:
        _put(sd, f"input_proj.{i}.0", p[f"input_proj_{i}"])
        _put_norm(sd, f"input_proj.{i}.1", p[f"input_proj_norm_{i}"])
        i += 1
    sd["transformer.level_embed"] = _tensor(p["level_embed"])

    i = 0
    while f"enc_layer_{i}" in p:
        k, q = f"transformer.encoder.fusion_layers.{i}", p[f"fusion_{i}"]
        _put_norm(sd, f"{k}.layer_norm_v", q["layer_norm_v"])
        _put_norm(sd, f"{k}.layer_norm_l", q["layer_norm_l"])
        _put_all_linear(sd, f"{k}.attn", q["attn"], ("v_proj", "l_proj", "values_v_proj",
                                                      "values_l_proj", "out_v_proj",
                                                      "out_l_proj"))
        sd[f"{k}.gamma_v"] = _tensor(q["gamma_v"])
        sd[f"{k}.gamma_l"] = _tensor(q["gamma_l"])
        k, q = f"transformer.encoder.text_layers.{i}", p[f"text_layer_{i}"]
        _put_mha(sd, f"{k}.self_attn", q["self_attn"])
        _put_all_linear(sd, k, q, ("linear1", "linear2"))
        _put_norm(sd, f"{k}.norm1", q["norm1"])
        _put_norm(sd, f"{k}.norm2", q["norm2"])
        k, q = f"transformer.encoder.layers.{i}", p[f"enc_layer_{i}"]
        _put_all_linear(sd, f"{k}.self_attn", q["self_attn"], _MSDEFORM)
        _put_norm(sd, f"{k}.norm1", q["norm1"])
        _put_all_linear(sd, k, q, ("linear1", "linear2"))
        _put_norm(sd, f"{k}.norm2", q["norm2"])
        i += 1

    _put_linear(sd, "transformer.enc_output", p["enc_output"])
    _put_norm(sd, "transformer.enc_output_norm", p["enc_output_norm"])
    _put_mlp(sd, "transformer.enc_out_bbox_embed", p["enc_out_bbox_embed"])
    sd["transformer.tgt_embed.weight"] = _tensor(p["tgt_embed"])

    i = 0
    while f"dec_layer_{i}" in p:
        k, q = f"transformer.decoder.layers.{i}", p[f"dec_layer_{i}"]
        _put_mha(sd, f"{k}.self_attn", q["self_attn"])
        _put_norm(sd, f"{k}.norm2", q["norm2"])
        _put_mha(sd, f"{k}.ca_text", q["ca_text"])
        _put_norm(sd, f"{k}.catext_norm", q["catext_norm"])
        _put_all_linear(sd, f"{k}.cross_attn", q["cross_attn"], _MSDEFORM)
        _put_norm(sd, f"{k}.norm1", q["norm1"])
        _put_all_linear(sd, k, q, ("linear1", "linear2"))
        _put_norm(sd, f"{k}.norm3", q["norm3"])
        i += 1
    _put_mlp(sd, "transformer.decoder.ref_point_head", p["ref_point_head"])
    _put_norm(sd, "transformer.decoder.norm", p["dec_norm"])
    _put_mlp(sd, "bbox_embed.0", p["bbox_embed"])
    return sd


def _put_frozen_bn(sd: dict, key: str, p: dict):
    sd[f"{key}.weight"] = _tensor(p["scale"])
    sd[f"{key}.bias"] = _tensor(p["bias"])
    sd[f"{key}.running_mean"] = _tensor(p["mean"])
    sd[f"{key}.running_var"] = _tensor(p["var"])


def deaot_state_dict_from_flax(params) -> dict:
    """``vipe_tpu``'s ``DeAOTNet`` params (numpy leaves) → the port's state
    dict, the reference's key layout (inverse of ``convert_deaot``)."""
    p = params["params"] if "params" in params else params
    sd: dict = {}
    pe = p["encoder"]
    _put(sd, "encoder.conv1", pe["conv1"])
    _put_frozen_bn(sd, "encoder.bn1", pe["bn1"])
    s = 1
    while f"layer{s}_0" in pe:
        b = 0
        while f"layer{s}_{b}" in pe:
            k, q = f"encoder.layer{s}.{b}", pe[f"layer{s}_{b}"]
            for n in (1, 2, 3):
                _put(sd, f"{k}.conv{n}", q[f"conv{n}"])
                _put_frozen_bn(sd, f"{k}.bn{n}", q[f"bn{n}"])
            if "downsample_conv" in q:
                _put(sd, f"{k}.downsample.0", q["downsample_conv"])
                _put_frozen_bn(sd, f"{k}.downsample.1", q["downsample_bn"])
            b += 1
        s += 1
    _put(sd, "encoder_projector", p["encoder_projector"])

    i = 0
    while f"lstt_{i}" in p:
        k, q = f"LSTT.layers.{i}", p[f"lstt_{i}"]
        for name in ("norm1", "norm2", "id_norm2", "id_norm1"):
            if name in q:
                _put_norm(sd, f"{k}.{name}", q[name])
        for name in ("linear_QV", "linear_U", "linear_ID_V", "linear_ID_U"):
            if name in q:
                _put_linear(sd, f"{k}.{name}", q[name])
        for branch in ("long_term_attn", "short_term_attn", "self_attn"):
            qb = q[branch]
            _put(sd, f"{k}.{branch}.dw_conv.conv", qb["dw_conv"]["conv"])
            _put_linear(sd, f"{k}.{branch}.projection", qb["projection"])
            for name in ("linear_QK", "linear_V1", "linear_V2", "linear_U1", "linear_U2"):
                if name in qb:
                    _put_linear(sd, f"{k}.{branch}.{name}", qb[name])
            if "relative_emb_k" in qb:
                _put(sd, f"{k}.{branch}.relative_emb_k", qb["relative_emb_k"])
        i += 1
    _put_norm(sd, "LSTT.decoder_norms.0.gn", p["decoder_norm"])
    _put(sd, "patch_wise_id_bank", p["patch_wise_id_bank"])
    _put_norm(sd, "id_norm", p["id_norm"])
    for name in ("in", "16x", "8x", "4x"):
        _put(sd, f"decoder.conv_{name}.conv", p[f"dec_conv_{name}"])
        _put_norm(sd, f"decoder.conv_{name}.gn", p[f"dec_gn_{name}"])
    for name in ("adapter_16x", "adapter_8x", "adapter_4x", "conv_out"):
        _put(sd, f"decoder.{name}", p[f"dec_{name}"])
    return sd
