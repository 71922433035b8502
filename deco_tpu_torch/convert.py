"""Weight bridge from the JAX ``DeCoC2I`` and ``DeCoT2I`` parameter trees to the port.

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

:func:`train_checkpoint_from_jax` turns a JAX c2i or t2i training state (params, EMA,
optax AdamW moments and count) into the port's step checkpoint
(``train/checkpoint.py``), so a run started in the JAX package resumes in
the port.
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


def state_dict_from_jax(params: dict, in_channels: int = 3,
                        patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``DeCoC2I`` params (nested dicts of arrays, optionally under a
    ``"params"`` key) -> the port's ``DeCoC2I`` state dict (fp32 tensors)."""
    p = params.get("params", params)
    out: dict = {}
    out["s_embedder.proj.weight"] = _unfold_perm_inv(
        p["s_embedder"]["proj"]["kernel"], in_channels, patch_size)
    out["s_embedder.proj.bias"] = np.asarray(p["s_embedder"]["proj"]["bias"])
    _dense(p["t_embedder"]["mlp_0"], out, "t_embedder.mlp.0")
    _dense(p["t_embedder"]["mlp_2"], out, "t_embedder.mlp.2")
    out["y_embedder.embedding_table.weight"] = np.asarray(p["y_embedder"]["embedding"])
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    blocks = p["blocks"]["block"]
    for i in range(np.asarray(blocks["norm1"]["weight"]).shape[0]):
        _dit_block(blocks, out, f"blocks.{i}.", i)
    _pixel_decoder(p["dec_net"], out, "dec_net.")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


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


def state_dict_from_jax_t2i(params: dict, in_channels: int = 3,
                            patch_size: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``DeCoT2I`` params (optionally under ``"params"``) -> the port's
    ``DeCoT2I`` state dict (fp32 tensors), the keys and arrays of
    ``export_deco_t2i(prefix="")``."""
    p = params.get("params", params)
    trunk = p["trunk"]
    out: dict = {}
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
    for i in range(np.asarray(blocks["norm1"]["weight"]).shape[0]):
        _t2i_block(blocks, out, f"blocks.{i}.", i, joint=True)
    _dense(p["x_embedder"]["embedder"], out, "x_embedder.embedder.0")
    _pixel_decoder(p["dec_net"], out, "dec_net.")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def train_checkpoint_from_jax(params: dict, ema_params, mu: dict, nu: dict, count, step: int,
                              in_channels: int = 3, patch_size: int = 16) -> dict:
    """A port step checkpoint (``train.checkpoint.payload``) from numpy trees
    of the JAX ``TrainState``: ``params`` and ``ema_params`` (or None), the
    AdamW first and second moments ``mu``/``nu`` of optax's
    ``ScaleByAdamState`` and its ``count``, and the train step. The moments
    have the parameters' layout and go through the same transforms; optax's
    ``count`` (updates taken) is torch AdamW's ``step``. A ``DeCoT2I`` tree
    (its parameters under ``trunk``) goes through
    :func:`state_dict_from_jax_t2i`, a ``DeCoC2I`` tree through
    :func:`state_dict_from_jax`."""
    from deco_tpu_torch.train.checkpoint import payload

    t2i = "trunk" in params.get("params", params)
    bridge = state_dict_from_jax_t2i if t2i else state_dict_from_jax

    def convert(tree):
        return bridge(tree, in_channels=in_channels, patch_size=patch_size)

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
