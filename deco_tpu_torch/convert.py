"""Weight bridge from the JAX model parameter trees to the port.

:func:`state_dict_from_jax` writes the keys and layouts of the reference
torch model (those of ``deco_tpu/convert/flax_to_torch.py``
``export_deco_c2i(prefix="")``, of which this is the port's own copy): Dense
kernels (in, out) become Linear weights (out, in), the ``nn.scan``-stacked
trunk unstacks into ``blocks.{i}``, and the ``s_embedder`` weight is written
channel-major, the order of torch ``unfold`` patches.
:func:`state_dict_from_jax_t2i` is the port's copy of
``export_deco_t2i(prefix="")``: the same transforms, the fused SwiGLU layout
(``w12 = [w1; gate]``, ``w3`` = the JAX ``w2``), and the text-refine
blocks' flat ``attn_*`` parameters under ``attn.``.
:func:`state_dict_from_jax_baseline`, :func:`state_dict_from_jax_pixnerd`
and :func:`state_dict_from_jax_pixnerd_t2i` write the reference
``FlattenDiT`` and ``PixNerDiT`` layouts that ``convert_baseline_dit``,
``convert_pixnerd_c2i`` and ``convert_deco_t2i(pixnerd=True)`` read (the
NerfBlocks follow the trunk blocks in ``blocks``; the baseline's patch
pixels in and out are channel-major). :func:`state_dict_from_jax_reco`
writes the reference ReCo layout that ``convert_reco`` reads.
:func:`vit_state_dict_from_jax` and :func:`dinov2_state_dict_from_jax`
write the port's ``VisionModel`` and ``DINOv2`` (the InternViT key names),
and :func:`repa_proj_state_dict_from_jax` the REPA projection (``fc0-2``
to ``proj.0.{0,2,4}``).

:func:`dcae_from_torch_state` builds the port's ``AutoencoderDC`` from a
diffusers (or the reference's vendored) DC-AE state dict, the stage
geometry inferred from the weights as ``deco_tpu/convert/dcae_bridge.py``
does; the port's modules carry the diffusers names, so the dict loads
as it is.

:func:`state_dict_from_jax_uniflow` writes the reference UniFlow layout
(``uniflow_bridge.uniflow_params_to_torch(prefix="")``), and
:func:`uniflow_state_dict` selects the ``model.`` (or ``ema_model.``)
namespace of a reference Lightning checkpoint and fills the absent
``mask_token`` of each flow head with zeros, so that either loads into
``UniFlowVision`` as it is.

:func:`train_checkpoint_from_jax` turns a JAX c2i, t2i or ReCo training
state (params, EMA, optax AdamW moments and count) into the port's step
checkpoint (``train/checkpoint.py``), so a run started in the JAX package
resumes in the port.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(kernel):  # Dense kernel (in, out) -> Linear weight (out, in)
    return np.ascontiguousarray(np.asarray(kernel).T)


def _unfold_perm_inv(kernel, in_channels: int, patch_size: int):
    """(p2*C, out) pixel-major kernel -> (out, C*p2) channel-major weight."""
    p2 = patch_size * patch_size
    out_dim = kernel.shape[1]
    k = np.asarray(kernel).reshape(p2, in_channels, out_dim)
    return np.ascontiguousarray(np.transpose(k, (2, 1, 0)).reshape(out_dim, in_channels * p2))


def _dit_block(blocks: dict, out: dict, prefix: str, i: int):
    def g(*path):
        node = blocks
        for p in path:
            node = node[p]
        return np.asarray(node[i])

    out[f"{prefix}adaLN_modulation.0.weight"] = _t(g("adaLN_modulation", "kernel"))
    out[f"{prefix}adaLN_modulation.0.bias"] = g("adaLN_modulation", "bias")
    out[f"{prefix}norm1.weight"] = g("norm1", "weight")
    out[f"{prefix}norm2.weight"] = g("norm2", "weight")
    for w in ("w1", "w2", "w3"):
        out[f"{prefix}mlp.{w}.weight"] = _t(g("mlp", w, "kernel"))
    out[f"{prefix}attn.qkv.weight"] = _t(g("attn", "qkv", "kernel"))
    out[f"{prefix}attn.q_norm.weight"] = g("attn", "q_norm", "weight")
    out[f"{prefix}attn.k_norm.weight"] = g("attn", "k_norm", "weight")
    out[f"{prefix}attn.proj.weight"] = _t(g("attn", "proj", "kernel"))
    out[f"{prefix}attn.proj.bias"] = g("attn", "proj", "bias")


def _dense(node: dict, out: dict, key: str):
    out[f"{key}.weight"] = _t(node["kernel"])
    out[f"{key}.bias"] = np.asarray(node["bias"])


def _pixel_decoder(dec: dict, out: dict, prefix: str):
    _dense(dec["input_proj"], out, prefix + "input_proj")
    _dense(dec["cond_embed"], out, prefix + "cond_embed")
    _dense(dec["final_linear"], out, prefix + "final_layer.linear")
    i = 0
    while f"res_blocks_{i}" in dec:
        rb = dec[f"res_blocks_{i}"]
        p = f"{prefix}res_blocks.{i}."
        out[p + "in_ln.weight"] = np.asarray(rb["in_ln"]["scale"])
        out[p + "in_ln.bias"] = np.asarray(rb["in_ln"]["bias"])
        _dense(rb["mlp_0"], out, p + "mlp.0")
        _dense(rb["mlp_2"], out, p + "mlp.2")
        _dense(rb["adaLN_modulation"], out, p + "adaLN_modulation.1")
        i += 1


def _tensors(out: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def _c2i_trunk(p: dict, out: dict, embedder: str, in_channels: int, patch_size: int) -> int:
    """The c2i embedders and trunk blocks; returns the number of blocks."""
    out[f"{embedder}.proj.weight"] = _unfold_perm_inv(
        p[embedder]["proj"]["kernel"], in_channels, patch_size)
    out[f"{embedder}.proj.bias"] = np.asarray(p[embedder]["proj"]["bias"])
    _dense(p["t_embedder"]["mlp_0"], out, "t_embedder.mlp.0")
    _dense(p["t_embedder"]["mlp_2"], out, "t_embedder.mlp.2")
    out["y_embedder.embedding_table.weight"] = np.asarray(p["y_embedder"]["embedding"])
    blocks = p["blocks"]["block"]
    n = np.asarray(blocks["norm1"]["weight"]).shape[0]
    for i in range(n):
        _dit_block(blocks, out, f"blocks.{i}.", i)
    return n


def _nerf_blocks(p: dict, out: dict, first: int) -> None:
    i = 0
    while f"nerf_blocks_{i}" in p:
        nb = p[f"nerf_blocks_{i}"]
        _dense(nb["param_generator1"], out, f"blocks.{first + i}.param_generator1.0")
        out[f"blocks.{first + i}.norm.weight"] = np.asarray(nb["norm"]["weight"])
        i += 1


def state_dict_from_jax(params: dict, in_channels: int = 3,
                        patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``DeCoC2I`` params (nested dicts of arrays, optionally under a
    ``"params"`` key) -> the port's ``DeCoC2I`` state dict (fp32 tensors)."""
    p = params.get("params", params)
    out: dict = {}
    _c2i_trunk(p, out, "s_embedder", in_channels, patch_size)
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    _pixel_decoder(p["dec_net"], out, "dec_net.")
    return _tensors(out)


def _pixel_major_perm(in_channels: int, patch_size: int) -> np.ndarray:
    """Index map: pixel-major position (u*C + c) -> unfold position (c*p2 + u)."""
    p2 = patch_size * patch_size
    return np.asarray([c * p2 + u for u in range(p2) for c in range(in_channels)])


def state_dict_from_jax_baseline(params: dict, in_channels: int = 3,
                                 patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``BaselineDiT`` params -> the port's ``BaselineDiT`` state dict,
    the reference ``FlattenDiT`` layout (the inverse of ``convert_baseline_dit``):
    ``final_layer.linear`` writes the patch pixels channel-major."""
    p = params.get("params", params)
    out: dict = {}
    _c2i_trunk(p, out, "x_embedder", in_channels, patch_size)
    final = p["final_layer"]
    _dense(final["adaLN_modulation"], out, "final_layer.adaLN_modulation.0")
    perm = _pixel_major_perm(in_channels, patch_size)
    kernel = np.asarray(final["linear"]["kernel"])
    weight_t, bias = np.empty_like(kernel), np.empty(kernel.shape[1], np.float32)
    weight_t[:, perm] = kernel
    bias[perm] = np.asarray(final["linear"]["bias"])
    out["final_layer.linear.weight"] = _t(weight_t)
    out["final_layer.linear.bias"] = bias
    return _tensors(out)


def state_dict_from_jax_pixnerd(params: dict, in_channels: int = 3,
                                patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``PixNerdC2I`` params -> the port's ``PixNerdC2I`` state dict,
    the reference ``PixNerDiT`` layout (the inverse of ``convert_pixnerd_c2i``)."""
    p = params.get("params", params)
    out: dict = {}
    n = _c2i_trunk(p, out, "s_embedder", in_channels, patch_size)
    _nerf_blocks(p, out, n)
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    out["final_layer.norm.weight"] = np.asarray(p["final_norm"]["weight"])
    _dense(p["final_linear"], out, "final_layer.linear")
    return _tensors(out)


def _t2i_block(blocks: dict, out: dict, prefix: str, i: int, joint: bool):
    def g(*path):
        node = blocks
        for p in path:
            node = node[p]
        return np.asarray(node[i])

    out[f"{prefix}adaLN_modulation.0.weight"] = _t(g("adaLN_modulation", "kernel"))
    out[f"{prefix}adaLN_modulation.0.bias"] = g("adaLN_modulation", "bias")
    out[f"{prefix}norm1.weight"] = g("norm1", "weight")
    out[f"{prefix}norm2.weight"] = g("norm2", "weight")
    out[f"{prefix}mlp.w12.weight"] = np.concatenate(
        [_t(g("mlp", "w1", "kernel")), _t(g("mlp", "w3", "kernel"))], axis=0)
    out[f"{prefix}mlp.w3.weight"] = _t(g("mlp", "w2", "kernel"))
    if joint:
        names = ("qkv_x", "kv_y", "q_norm", "k_norm", "proj")
        path = lambda name: ("attn", name)  # noqa: E731
    else:  # the text-refine block's attention parameters are flat in JAX
        names = ("qkv", "q_norm", "k_norm", "proj")
        path = lambda name: ("attn_" + name,)  # noqa: E731
    for name in names:
        key = f"{prefix}attn.{name}.weight"
        if name.endswith("norm"):
            out[key] = g(*path(name), "weight")
        else:
            out[key] = _t(g(*path(name), "kernel"))
    out[f"{prefix}attn.proj.bias"] = g(*path("proj"), "bias")


def _t2i_trunk(trunk: dict, out: dict, in_channels: int, patch_size: int) -> int:
    """The t2i trunk's keys; returns the number of joint blocks."""
    out["s_embedder.proj.weight"] = _unfold_perm_inv(
        trunk["s_embedder"]["proj"]["kernel"], in_channels, patch_size)
    out["s_embedder.proj.bias"] = np.asarray(trunk["s_embedder"]["proj"]["bias"])
    _dense(trunk["t_embedder"]["mlp_0"], out, "t_embedder.mlp.0")
    _dense(trunk["t_embedder"]["mlp_2"], out, "t_embedder.mlp.2")
    _dense(trunk["y_embedder"]["proj"], out, "y_embedder.proj")
    out["y_embedder.norm.weight"] = np.asarray(trunk["y_embedder"]["norm"]["weight"])
    out["y_pos_embedding"] = np.asarray(trunk["y_pos_embedding"])
    text = trunk["text_refine_blocks"]["block"]
    for i in range(np.asarray(text["norm1"]["weight"]).shape[0]):
        _t2i_block(text, out, f"text_refine_blocks.{i}.", i, joint=False)
    blocks = trunk["blocks"]["block"]
    n = np.asarray(blocks["norm1"]["weight"]).shape[0]
    for i in range(n):
        _t2i_block(blocks, out, f"blocks.{i}.", i, joint=True)
    return n


def state_dict_from_jax_t2i(params: dict, in_channels: int = 3,
                            patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``DeCoT2I`` params (optionally under ``"params"``) -> the port's
    ``DeCoT2I`` state dict (fp32 tensors), the keys and arrays of
    ``export_deco_t2i(prefix="")``."""
    p = params.get("params", params)
    out: dict = {}
    _t2i_trunk(p["trunk"], out, in_channels, patch_size)
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    _pixel_decoder(p["dec_net"], out, "dec_net.")
    return _tensors(out)


def state_dict_from_jax_pixnerd_t2i(params: dict, in_channels: int = 3,
                                    patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``PixNerdT2I`` params -> the port's ``PixNerdT2I`` state dict, the
    layout ``convert_deco_t2i(pixnerd=True)`` reads."""
    p = params.get("params", params)
    out: dict = {}
    n = _t2i_trunk(p["trunk"], out, in_channels, patch_size)
    _nerf_blocks(p, out, n)
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    _dense(p["final_linear"], out, "final_layer.linear")
    return _tensors(out)


def vit_state_dict_from_jax(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX ``VisionModel`` tree (optionally under ``"params"``) -> the
    port's ``VisionModel`` state dict (the InternViT torch names), keys
    under ``prefix``: the HWIO patch kernel becomes the (C, 3, p, p) conv
    weight, the scanned layers unstack, LayerNorm ``scale`` becomes
    ``weight``."""
    vit = params.get("params", params)
    emb = vit["embeddings"]
    out = {"embeddings.class_embedding": emb["class_embedding"],
           "embeddings.position_embedding": emb["position_embedding"],
           "embeddings.patch_embedding.weight": np.transpose(
               np.asarray(emb["patch_embedding"]["kernel"]), (3, 2, 0, 1)),
           "embeddings.patch_embedding.bias": emb["patch_embedding"]["bias"]}
    layer = vit["encoder"]["layers"]["layer"]
    for i in range(np.asarray(layer["ls1"]).shape[0]):
        pre = f"encoder.layers.{i}."
        for name, key in (("norm1", "norm1"), ("norm2", "norm2"), ("q_norm", "attn.q_norm"),
                          ("k_norm", "attn.k_norm")):
            for leaf, value in layer.get(name, {}).items():
                out[f"{pre}{key}.{'weight' if leaf == 'scale' else leaf}"] = np.asarray(value)[i]
        for name, key in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                          ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[pre + key + ".weight"] = _t(np.asarray(layer[name]["kernel"])[i])
            if "bias" in layer[name]:
                out[pre + key + ".bias"] = np.asarray(layer[name]["bias"])[i]
        out[pre + "ls1"] = np.asarray(layer["ls1"])[i]
        out[pre + "ls2"] = np.asarray(layer["ls2"])[i]
    return _tensors({prefix + k: v for k, v in out.items()})


def dinov2_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``DINOv2`` tower's ``.params`` (the ``VisionModel`` tree under
    ``"params"``, and ``final_norm`` {scale, bias} when the weights carry it)
    -> the port's ``DINOv2`` state dict."""
    out = vit_state_dict_from_jax(params["params"], prefix="model.")
    if params.get("final_norm") is not None:
        out.update(_tensors({"final_norm.weight": params["final_norm"]["scale"],
                             "final_norm.bias": params["final_norm"]["bias"]}))
    return out


def repa_proj_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX REPA projection (``fc0``, ``fc1``, ``fc2``) -> the port's
    ``REPAProjection`` state dict (``proj.0.0``, ``proj.0.2``, ``proj.0.4``)."""
    out: dict = {}
    for i in range(3):
        _dense(params[f"fc{i}"], out, f"proj.0.{2 * i}")
    return _tensors(out)


def moe_state_dict_from_jax(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX ``MoEMLP`` tree (``router`` (d, E), ``w1``/``w3`` (E, d, m),
    ``w2`` (E, m, d)) as the port's ``MoEMLP`` state dict, which keeps the
    JAX layout (no transposes)."""
    return _tensors({prefix + k: params[k] for k in ("router", "w1", "w3", "w2")})


def _plain_dit_block(block: dict, out: dict, prefix: str):
    """A JAX ``PlainDiTBlock`` (its own subtree, not scanned) in the
    reference ``FlattenDiTBlock`` layout: the fused SwiGLU (``w12 = [w1; w3]``,
    ``w3`` = the JAX ``w2``), the attention without a qkv bias."""
    out[f"{prefix}norm1.weight"] = np.asarray(block["norm1"]["weight"])
    out[f"{prefix}norm2.weight"] = np.asarray(block["norm2"]["weight"])
    attn = block["attn"]
    out[f"{prefix}attn.qkv.weight"] = _t(attn["qkv"]["kernel"])
    out[f"{prefix}attn.q_norm.weight"] = np.asarray(attn["q_norm"]["weight"])
    out[f"{prefix}attn.k_norm.weight"] = np.asarray(attn["k_norm"]["weight"])
    _dense(attn["proj"], out, f"{prefix}attn.proj")
    mlp = block["mlp"]
    out[f"{prefix}mlp.w12.weight"] = np.concatenate(
        [_t(mlp["w1"]["kernel"]), _t(mlp["w3"]["kernel"])], axis=0)
    out[f"{prefix}mlp.w3.weight"] = _t(mlp["w2"]["kernel"])


def state_dict_from_jax_reco(params: dict, **layout) -> dict[str, torch.Tensor]:
    """JAX ``ReCoModel`` params (optionally under ``"params"``) -> the port's
    ``ReCoModel`` state dict, the reference ``dit_t2i_DeCo.PixNerDiT`` layout
    that ``convert_reco`` reads: ``vision_model.*`` (the InternViT names),
    ``mlp1.{0,1,3}``, ``latent_projector.{0,2}`` and ``pixel_decoder.*``
    (learnable tokens, embedders, plain DiT blocks, ``dec_net``). ``layout``
    (the c2i ``in_channels``/``patch_size``) is taken for a uniform bridge
    call and not needed: no ReCo weight reads patches channel-major."""
    del layout
    p = params.get("params", params)
    out: dict = {"mlp1.0.weight": np.asarray(p["mlp1_norm"]["scale"]),
                 "mlp1.0.bias": np.asarray(p["mlp1_norm"]["bias"])}
    _dense(p["mlp1_fc1"], out, "mlp1.1")
    _dense(p["mlp1_fc2"], out, "mlp1.3")
    _dense(p["latent_fc1"], out, "latent_projector.0")
    _dense(p["latent_fc2"], out, "latent_projector.2")
    dec, pd = p["pixel_decoder"], "pixel_decoder."
    out[pd + "learnable_tokens"] = np.asarray(dec["learnable_tokens"])
    _dense(dec["s_embedder"]["proj"], out, pd + "s_embedder.proj")
    _dense(dec["x_embedder"]["embedder"], out, pd + "x_embedder.embedder.0")
    _dense(dec["t_embedder"]["mlp_0"], out, pd + "t_embedder.mlp.0")
    _dense(dec["t_embedder"]["mlp_2"], out, pd + "t_embedder.mlp.2")
    i = 0
    while f"blocks_{i}" in dec:
        _plain_dit_block(dec[f"blocks_{i}"], out, f"{pd}blocks.{i}.")
        i += 1
    _pixel_decoder(dec["dec_net"], out, pd + "dec_net.")
    return {**vit_state_dict_from_jax(p["vision_model"], prefix="vision_model."), **_tensors(out)}


def _res_blocks(tree: dict, out: dict, prefix: str):
    """The gated res blocks ``res_blocks_{i}`` of a JAX subtree under ``prefix + res_blocks.{i}.``."""
    i = 0
    while f"res_blocks_{i}" in tree:
        rb, pre = tree[f"res_blocks_{i}"], f"{prefix}res_blocks.{i}."
        out[pre + "in_ln.weight"] = np.asarray(rb["in_ln"]["scale"])
        out[pre + "in_ln.bias"] = np.asarray(rb["in_ln"]["bias"])
        _dense(rb["mlp_0"], out, pre + "mlp.0")
        _dense(rb["mlp_2"], out, pre + "mlp.2")
        _dense(rb["adaLN_modulation"], out, pre + "adaLN_modulation.1")
        i += 1


def _gated_final_layer(tree: dict, out: dict, prefix: str):
    _dense(tree["adaLN_modulation"], out, prefix + "adaLN_modulation.1")
    _dense(tree["linear"], out, prefix + "linear")


def _flow_decoder(tree: dict, out: dict, prefix: str):
    net, pre = tree["net"], prefix + "net."
    _dense(tree["nerf_embedder"]["embedder"], out, prefix + "nerf_embedder.embedder.0")
    _dense(net["time_embed"]["mlp_0"], out, pre + "time_embed.mlp.0")
    _dense(net["time_embed"]["mlp_2"], out, pre + "time_embed.mlp.2")
    _dense(net["cond_embed"], out, pre + "cond_embed")
    _dense(net["input_proj"], out, pre + "input_proj")
    _res_blocks(net, out, pre)
    _gated_final_layer(net["final_layer"], out, pre + "final_layer.")
    out[prefix + "mask_token"] = np.asarray(tree["mask_token"])


def state_dict_from_jax_uniflow(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``UniFlowVision`` params (optionally under ``"params"``) -> the
    port's ``UniFlowVision`` state dict: the reference ``UniFlowVisionModel``
    keys that ``uniflow_params_to_torch(prefix="")`` writes (``embeddings.*``,
    ``encoder.layers.N.*``, ``shallow_embeddings.*``, ``shallow_encoder.*``,
    ``mlp1.{0,1,3}``, ``shared_latent_proj.*``, ``gen_latent_proj.{0,2}``,
    ``sem_latent_proj.{0,2}``, the position embeddings, ``global_blocks.N.*``,
    ``sem_global_blocks.N.*``, ``flow_head.*``, ``sem_flow_head.*`` with
    ``mask_token``). The DC-AE pixel branch's ``dcae_decoder.*`` is not
    written: those weights carry the diffusers names (``dcae_from_torch_state``)."""
    p = params.get("params", params)
    out: dict = {"mlp1.0.weight": np.asarray(p["mlp1_norm"]["scale"]),
                 "mlp1.0.bias": np.asarray(p["mlp1_norm"]["bias"])}
    _dense(p["mlp1_fc1"], out, "mlp1.1")
    _dense(p["mlp1_fc2"], out, "mlp1.3")
    slp, pre = p["shared_latent_proj"], "shared_latent_proj."
    for name in ("input_proj", "cond_proj", "post_shuffle_proj"):
        _dense(slp[name], out, pre + name)
    _res_blocks(slp, out, pre)
    _gated_final_layer(slp["final_layer"], out, pre + "final_layer.")
    for jax_name, key in (("gen_latent_proj", "gen_latent_proj"), ("sem_latent_proj",
                                                                    "sem_latent_proj")):
        if f"{jax_name}_fc1" in p:
            _dense(p[f"{jax_name}_fc1"], out, key + ".0")
            _dense(p[f"{jax_name}_fc2"], out, key + ".2")
    for branch in ("", "sem_"):
        if f"{branch}global_block_pos_embed" in p:
            out[f"{branch}global_block_pos_embed"] = np.asarray(p[f"{branch}global_block_pos_embed"])
        i = 0
        while f"{branch}global_blocks_{i}" in p:
            _plain_dit_block(p[f"{branch}global_blocks_{i}"], out, f"{branch}global_blocks.{i}.")
            i += 1
        head = f"{branch}flow_head"
        if head in p:
            _flow_decoder(p[head], out, head + ".")
    return {**vit_state_dict_from_jax(p["vision"]),
            **vit_state_dict_from_jax(p["shallow"], "shallow_"), **_tensors(out)}


def uniflow_state_dict(sd: dict, use_ema: bool = False) -> dict:
    """A reference UniFlow checkpoint's state dict as ``UniFlowVision``
    loads it: the Lightning ``model.`` namespace (``ema_model.`` with
    ``use_ema``) selected when present, as ``uniflow_bridge._strip_prefix``
    does, and each flow head's ``mask_token`` filled with zeros when absent
    (the reference model has none)."""
    want = "ema_model." if use_ema else "model."
    if any(k.startswith(want) for k in sd):
        sd = {k[len(want):]: v for k, v in sd.items() if k.startswith(want)}
    sd = dict(sd)
    for head in ("flow_head", "sem_flow_head"):
        key = f"{head}.net.cond_embed.weight"
        if key in sd and f"{head}.mask_token" not in sd:
            sd[f"{head}.mask_token"] = torch.zeros(1, 1, sd[key].shape[1])
    return sd


def _model_bridge(params: dict):
    """The converter of a JAX model tree, told apart by its top-level keys."""
    p = params.get("params", params)
    if "shared_latent_proj" in p:
        return state_dict_from_jax_uniflow
    if "pixel_decoder" in p:
        return state_dict_from_jax_reco
    if "trunk" in p:
        return state_dict_from_jax_pixnerd_t2i if "final_linear" in p else state_dict_from_jax_t2i
    if "final_layer" in p:
        return state_dict_from_jax_baseline
    if "final_norm" in p:
        return state_dict_from_jax_pixnerd
    return state_dict_from_jax


def train_checkpoint_from_jax(params: dict, ema_params, mu: dict, nu: dict, count, step: int,
                              in_channels: int = 3, patch_size: int = 16) -> dict:
    """A port step checkpoint (``train.checkpoint.payload``) from numpy trees
    of the JAX ``TrainState``: ``params`` and ``ema_params`` (or None), the
    AdamW first and second moments ``mu``/``nu`` of optax's
    ``ScaleByAdamState`` and its ``count``, and the train step. The moments
    have the parameters' layout and go through the same transforms; optax's
    ``count`` (updates taken) is torch AdamW's ``step``. The model tree goes
    through the converter of its kind (``DeCoC2I``, ``DeCoT2I``,
    ``BaselineDiT``, ``PixNerdC2I``, ``PixNerdT2I``, ``ReCoModel``); a combined tree
    ``{"model", "trainer"}`` (a REPA run) also carries the projection, whose
    parameters, moments and EMA go under ``diffusion_trainer.``."""
    from deco_tpu_torch.train.checkpoint import payload
    from deco_tpu_torch.train.state import TRAINER_PREFIX

    combined = "model" in params and "trainer" in params
    bridge = _model_bridge(params["model"] if combined else params)

    def convert(tree):
        if not combined:
            return bridge(tree, in_channels=in_channels, patch_size=patch_size)
        out = bridge(tree["model"], in_channels=in_channels, patch_size=patch_size)
        trainer = repa_proj_state_dict_from_jax(tree["trainer"])
        return {**out, **{TRAINER_PREFIX + k: v for k, v in trainer.items()}}

    exp_avg, exp_avg_sq = convert(mu), convert(nu)
    adam_step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    moments = {name: {"exp_avg": exp_avg[name], "exp_avg_sq": exp_avg_sq[name],
                      "step": adam_step.clone()} for name in exp_avg}
    ema = None if ema_params is None else convert(ema_params)
    return payload(convert(params), ema, moments, int(step))


def load_checkpoint(path: str, ema: bool = True) -> dict[str, torch.Tensor]:
    """A reference-layout checkpoint (``.pt`` or ``.ckpt``, c2i or t2i) as
    the port's state dict.

    Accepts a bare state dict or ``{"state_dict": ...}``; keys under
    ``ema_denoiser.`` (preferred when ``ema``) or ``denoiser.`` lose that
    prefix, other keys are kept as they are.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj)
    for prefix in (("ema_denoiser.", "denoiser.") if ema else ("denoiser.",)):
        picked = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if picked:
            return picked
    return dict(sd)


def _seq_indices(sd: dict, prefix: str) -> list:
    """The sorted integer children of ``prefix`` in the state dict's keys."""
    idx = {int(head) for k in sd if k.startswith(prefix + ".")
           for head in [k[len(prefix) + 1:].split(".", 1)[0]] if head.isdigit()}
    return sorted(idx)


def infer_dcae_stage_config(sd: dict, blocks_key: str) -> tuple:
    """(block_out_channels, layers_per_block, attention_stages) of a bare
    DC-AE ``Encoder`` (``blocks_key`` "down_blocks") or ``Decoder``
    ("up_blocks") state dict, from the conv shapes: a stage holds blocks and
    at most one up/down block, whose only child is a bare ``conv``."""
    stages = _seq_indices(sd, blocks_key)
    channels, layers, attn = [], [], []
    for i in range(max(stages) + 1 if stages else 0):
        pre = f"{blocks_key}.{i}"
        blocks = [j for j in _seq_indices(sd, pre)
                  if f"{pre}.{j}.conv1.weight" in sd or f"{pre}.{j}.attn.qkv.weight" in sd]
        layers.append(len(blocks))
        if not blocks:
            channels.append(0)
            attn.append(False)
        elif f"{pre}.{blocks[0]}.conv1.weight" in sd:
            channels.append(int(sd[f"{pre}.{blocks[0]}.conv1.weight"].shape[0]))
            attn.append(False)
        else:
            channels.append(int(sd[f"{pre}.{blocks[0]}.attn.qkv.weight"].shape[1]))
            attn.append(True)
    return tuple(channels), tuple(layers), tuple(attn)


def dcae_from_torch_state(sd: dict, dtype=torch.float32, attention_head_dim: int = 32,
                          device="cuda"):
    """A diffusers ``AutoencoderDC`` state dict (``encoder.*`` and
    ``decoder.*``; the decoder's ``norm_out``/``conv_out`` head where the
    keys have it) -> the port's :class:`~deco_tpu_torch.models.dcae.AutoencoderDC`
    with those weights, loaded strictly. ``attention_head_dim`` is the one
    choice the weights cannot show (the qkv weight is square)."""
    from deco_tpu_torch.models.dcae import AutoencoderDC

    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    if not enc or not dec:
        raise ValueError("expected encoder.* and decoder.* keys")
    e_ch, e_layers, e_attn = infer_dcae_stage_config(enc, "down_blocks")
    d_ch, d_layers, d_attn = infer_dcae_stage_config(dec, "up_blocks")
    model = AutoencoderDC(
        latent_channels=int(enc["conv_out.weight"].shape[0]), dtype=dtype,
        encoder_block_out_channels=e_ch, encoder_layers_per_block=e_layers,
        encoder_attention_stages=e_attn, decoder_block_out_channels=d_ch,
        decoder_layers_per_block=d_layers, decoder_attention_stages=d_attn,
        attention_head_dim=attention_head_dim, decoder_head="norm_out.weight" in dec,
        device=device)
    model.load_state_dict(sd, strict=True)
    return model


def adv_head_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX adversarial head's params (``ConvHead``, ``ConvLinearMMHead`` or
    ``ConvMMHead``, optionally under ``"params"``) -> the port's head's
    state dict: each tower's ``conv{i}`` (HWIO kernel) becomes
    ``convs.{i}`` (OIHW), ``norm{i}``'s scale ``norms.{i}.weight``, each
    Dense a Linear."""
    p = params.get("params", params)
    out: dict = {}
    for name, node in p.items():
        if "conv0" in node:  # a conv tower
            for i in range(3):
                conv, norm = node[f"conv{i}"], node[f"norm{i}"]
                out[f"{name}.convs.{i}.weight"] = np.transpose(np.asarray(conv["kernel"]),
                                                               (3, 2, 0, 1))
                out[f"{name}.convs.{i}.bias"] = conv["bias"]
                out[f"{name}.norms.{i}.weight"] = norm["scale"]
                out[f"{name}.norms.{i}.bias"] = norm["bias"]
        else:
            _dense(node, out, name)
    return _tensors(out)
