"""The port's config surface (deco_tpu_torch.config, cli) against the JAX
package's: the YAML reader against PyYAML on every shipped config, the
class-path registry, instantiation of the DeCo configs, and the CLI's
workload selection and refusals."""

import glob
import math
import os

import numpy as np
import pytest
import torch
import yaml

from deco_tpu import cli as jax_cli
from deco_tpu.config import registry as jax_registry
from deco_tpu.train import workloads as jax_workloads
from deco_tpu_torch import cli
from deco_tpu_torch.config import _yaml, registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs*", "*.yaml")))
TINY_DENOISER = dict(hidden_size=32, num_groups=2, hidden_size_x=8, num_blocks=3,
                     num_cond_blocks=2, patch_size=16)


def _pyyaml(path):
    with open(os.path.join(REPO, path)) as f:
        return yaml.safe_load(f)


def _equal(a, b):
    """== that also holds NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


# ---- YAML ----

def test_every_config_is_found():
    assert len(CONFIGS) >= 40


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_load_equals_pyyaml_and_dump_round_trips(path):
    ours = _yaml.load(os.path.join(REPO, path))
    assert _equal(ours, _pyyaml(path))
    assert _equal(yaml.safe_load(_yaml.dump(ours)), ours)


SCALARS = """
lr: 1e-4
lr_dot: 1.0e-4
no_sign_exp: 1.5e3
ints: [0, -7, +3, 0x1f, 017, 1_000, 0b101, 1:30, 0o7]
floats: [1.5, -.5, .5, 1., 1_0.2_5, .inf, -.Inf, 2:30.5]
nan: .nan
bools: [yes, No, ON, off, True, false, y, n]
nulls: [~, null, Null, ]
empty:
strings: ['it''s', "tab\\there \\u00e9 \\x41", 'a: b', "q # not a comment", plain text]
flow: {a: 1, b: [x, {c: d}], e: []}   # a comment
"quoted key": 1
7: int key
"""


# one value each: YAML 1.1 floats (a dot needed), ints (bases, separators,
# sexagesimal), booleans, nulls, strings that look like numbers, quoted and
# flow values
SCALAR_TOKENS = [
    "1e-4", "1.0e-4", "1.5e3", "1.5e+3", "1E-4", "-1.5e-3", "1.0e4", "0", "-7", "+3", "0x1f",
    "0x_1F", "017", "09", "1_000", "0b101", "1:30", "-1:30", "0o7", "1.5", "-.5", ".5", "1.",
    ".inf", "-.Inf", "+.INF", ".nan", ".NaN", "2:30.5", "1_000.5", "yes", "Yes", "NO", "on",
    "OFF", "True", "false", "y", "n", "~", "null", "NULL", "nULL", "abc", "a b", "a:b", "1e4x",
    "0.1.2", "x # c", "'a''b'", '"\\x41\\u00e9"', "[]", "{}", "[a, [b, c]]",
    "{a: [1, {b: c}]}", "/data/x_y", "'1e-4'",
]


@pytest.mark.parametrize("token", SCALAR_TOKENS)
def test_yaml_value_resolves_like_pyyaml(token):
    assert _equal(_yaml.loads(f"v: {token}\n"), yaml.safe_load(f"v: {token}\n"))


def test_yaml_1_1_scalar_resolution_equals_pyyaml():
    ours = _yaml.loads(SCALARS)
    assert _equal(ours, yaml.safe_load(SCALARS))
    assert ours["lr"] == "1e-4" and ours["lr_dot"] == 1e-4 and ours["no_sign_exp"] == "1.5e3"


def test_yaml_alias_is_the_anchored_object():
    """pred_dataset: *eval shares its dict with eval_dataset, as in PyYAML,
    so an override of one is seen by both."""
    ours = _yaml.load(os.path.join(REPO, "configs_c2i/DeCo_XL.yaml"))
    ref = _pyyaml("configs_c2i/DeCo_XL.yaml")
    assert ref["data"]["pred_dataset"] is ref["data"]["eval_dataset"]
    assert ours["data"]["pred_dataset"] is ours["data"]["eval_dataset"]
    registry.apply_overrides(ours, {"data.pred_dataset.init_args.max_num_instances": 8})
    assert ours["data"]["eval_dataset"]["init_args"]["max_num_instances"] == 8


@pytest.mark.parametrize("text", ["a: |\n  block\n", "a: !!str 1\n", "a: b\n  c\n",
                                  "---\na: 1\n", "a: 2001-12-14\n", "a: *nope\n", "a: -\n"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        _yaml.loads(text)


def test_yaml_dump_round_trips_awkward_values():
    value = {"f": [1e-5, 1e300, -0.0, 2.5, math.inf, -math.inf], "s": ["1e-4", "yes", "null",
             "", "é \U0001F600", 'q"\\'], "n": None, "b": [True, False], 3: {},
             "l": [[], [1, [2]], {"k": {"k2": []}}]}
    assert yaml.safe_load(_yaml.dump(value)) == value


# ---- registry ----

def test_registry_has_the_jax_registry_keys():
    assert set(registry.REFERENCE_CLASS_MAP) == set(jax_registry.REFERENCE_CLASS_MAP)
    assert registry.VALUE_MAP == jax_registry.VALUE_MAP
    assert registry.DROPPED_ARGS == jax_registry.DROPPED_ARGS
    assert registry.RENAMED_ARGS == jax_registry.RENAMED_ARGS


@pytest.mark.parametrize("class_path", sorted(registry.UNPORTED))
def test_unported_class_path_raises_naming_its_roadmap_item(class_path):
    item = registry.UNPORTED[class_path]
    with pytest.raises(NotImplementedError, match=f"ROADMAP §A {item}") as err:
        registry.instantiate({"class_path": class_path, "init_args": {}})
    assert class_path in str(err.value)


def test_unknown_class_paths_are_refused():
    with pytest.raises(ValueError):
        registry.instantiate({"class_path": "src.models.nothing.Here"})
    with pytest.raises(ValueError):
        registry.resolve("deco_tpu.models.dit_c2i_deco.DeCoC2I")  # the JAX package


def _tiny(config):
    config["model"]["denoiser"]["init_args"].update(TINY_DENOISER)
    return config


@pytest.mark.parametrize("name", ["DeCo_XL", "DeCo_XL_freq", "DeCo_large_cpu", "DeCo_XL_512"])
def test_deco_configs_instantiate_like_jax(name):
    path = os.path.join(REPO, "configs_c2i", f"{name}.yaml")
    ours, ref = _tiny(registry.load_yaml(path)), _tiny(jax_registry.load_yaml(path))
    model_ref = jax_registry.instantiate(ref["model"]["denoiser"])
    node = ours["model"]["denoiser"]
    model = registry.instantiate({**node, "init_args": {**node["init_args"], "device": "cpu"}})
    assert model.hidden_size == model_ref.hidden_size and model.patch_size == model_ref.patch_size
    assert len(model.blocks) == model_ref.num_cond_blocks
    assert len(model.dec_net.res_blocks) == model_ref.num_blocks - model_ref.num_cond_blocks
    assert model.y_embedder.embedding_table.num_embeddings == model_ref.num_classes + 1
    assert model.trunk_checkpoint == bool(model_ref.grad_checkpoint)
    assert model.trunk_remat_policy == model_ref.trunk_remat_policy
    assert model.decoder_chunks == model_ref.decoder_chunks

    m, r = ours["model"], ref["model"]
    trainer, trainer_ref = (registry.instantiate(m["diffusion_trainer"]),
                            jax_registry.instantiate(r["diffusion_trainer"]))
    assert type(trainer).__name__ == type(trainer_ref).__name__ == "DeCoTrainer"
    for k in ("null_condition_p", "lognorm_t", "timeshift", "lognorm_mix_p", "feat_loss_weight",
              "align_layer", "freq_loss_weight", "enable_freq_loss"):
        assert getattr(trainer, k) == getattr(trainer_ref, k), k
    np.testing.assert_allclose(np.asarray(trainer.freq_w), np.asarray(trainer_ref.freq_w),
                               rtol=1e-6)

    sampler, sampler_ref = (registry.instantiate(m["diffusion_sampler"]),
                            jax_registry.instantiate(r["diffusion_sampler"]))
    for k in ("num_steps", "guidance", "guidance_interval_min", "guidance_interval_max",
              "step_type", "last_step"):
        assert getattr(sampler, k) == getattr(sampler_ref, k), k
    np.testing.assert_array_equal(sampler.timesteps, np.asarray(sampler_ref.timesteps))
    assert sampler.guidance_fn.__name__ == sampler_ref.guidance_fn.__name__

    ema, ema_ref = registry.instantiate(m["ema_tracker"]), jax_registry.instantiate(r["ema_tracker"])
    assert (ema.decay, ema.every_n_steps) == (ema_ref.decay, ema_ref.every_n_steps)
    opt, opt_ref = registry.instantiate(m["optimizer"]), jax_registry.instantiate(r["optimizer"])
    assert opt.lr == float(opt_ref.lr) and opt.betas == opt_ref.betas
    assert (opt.weight_decay, opt.eps) == (opt_ref.weight_decay, opt_ref.eps)
    assert registry.instantiate(m["conditioner"]).null_condition == jax_registry.instantiate(
        r["conditioner"]).null_condition
    assert registry.instantiate(m["vae"]).scale == jax_registry.instantiate(r["vae"]).scale

    data, data_ref = (registry.instantiate(ours["data"]["pred_dataset"]),
                      jax_registry.instantiate(ref["data"]["pred_dataset"]))
    assert len(data) == len(data_ref) and data.num_seeds == data_ref.num_seeds
    for i in (0, data.num_seeds):
        np.testing.assert_array_equal(data[i][0], data_ref[i][0])
        assert data[i][2]["filename"] == data_ref[i][2]["filename"]


def test_deco_trainer_takes_the_repa_arguments_of_deco_large():
    """configs_c2i/DeCo_large.yaml's trainer node (REPATrainer of
    training_repa_DeCo, mapped to DeCoTrainer) passes align_layer and the
    projection widths; both packages build it and store them alike. The
    encoder node is left out: it needs DINOv2 weights."""
    for load, instantiate in ((registry.load_yaml, registry.instantiate),
                              (jax_registry.load_yaml, jax_registry.instantiate)):
        node = load(os.path.join(REPO, "configs_c2i/DeCo_large.yaml"))["model"]["diffusion_trainer"]
        assert "encoder" in node["init_args"]
        del node["init_args"]["encoder"]
        trainer = instantiate(node)
        assert trainer.align_layer == 8 and trainer.feat_loss_weight == 0.5
        assert trainer.encoder is None and trainer.lognorm_t is True
    from deco_tpu_torch.diffusion.training import DeCoTrainer

    t = DeCoTrainer(scheduler=None, proj_denoiser_dim=1024, proj_hidden_dim=1024,
                    proj_encoder_dim=768)
    assert (t.proj_denoiser_dim, t.proj_hidden_dim, t.proj_encoder_dim) == (1024, 1024, 768)


def test_adamw_node_turns_the_yaml_1_1_lr_string_into_a_float():
    """PyYAML reads ``lr: 1e-4`` as the string '1e-4'. The JAX node keeps the
    string (a fault of the reference); the port's node makes it a float and
    the optimizer it builds uses 1e-4."""
    path = os.path.join(REPO, "configs_c2i/DeCo_XL.yaml")
    node = registry.load_yaml(path)["model"]["optimizer"]
    assert node["init_args"]["lr"] == "1e-4"
    assert jax_registry.instantiate(jax_registry.load_yaml(path)["model"]["optimizer"]).lr == "1e-4"
    opt = registry.instantiate(node)
    assert opt.lr == 1e-4 and isinstance(opt.lr, float)
    state = opt.create_state(torch.nn.Linear(2, 2))
    assert state.optimizer.param_groups[0]["lr"] == 1e-4
    with pytest.raises(ValueError):
        registry.instantiate({"class_path": "torch.optim.AdamW", "init_args": {"lr": "fast"}})


# the class paths ported with the eval slice, each as a YAML node of the
# configs' form, with the arguments a config would give
PORTED_NODES = {
    "src.diffusion.flow_matching.scheduling.GVPScheduler": "{}",
    "src.diffusion.flow_matching.scheduling.ConstScheduler": "{}",
    "src.diffusion.flow_matching.scheduling.VPBetaScheduler": "{beta_min: 0.1, beta_max: 20.0}",
    "src.diffusion.ddpm.scheduling.VPScheduler": "{beta_min: 0.1, beta_max: 20.0}",
    "src.diffusion.ddpm.scheduling.DDPMScheduler": "{num_steps: 1000}",
    "src.diffusion.flow_matching.sampling.EulerSamplerJiT":
        "{num_steps: 50, guidance: 2.9, timeshift: 3.0, scheduler: %(linear)s}",
    "src.diffusion.flow_matching.sampling.HeunSampler":
        "{num_steps: 25, guidance: 3.0, exact_heun: true, scheduler: %(linear)s, "
        "w_scheduler: %(linear)s, step_fn: src.diffusion.flow_matching.sampling.ode_step_fn}",
    "src.diffusion.flow_matching.adam_sampling.AdamLMSampler":
        "{num_steps: 25, guidance: 4.0, timeshift: 3.0, order: 3, scheduler: %(linear)s, "
        "lms_transform_fn: src.diffusion.flow_matching.adam_sampling.t2logsnr}",
    "src.diffusion.ddpm.ddim_sampling.DDIMSampler":
        "{num_steps: 50, guidance: 1.5, scheduler: src.diffusion.ddpm.scheduling.DDPMScheduler}",
    "src.diffusion.ddpm.vp_sampling.VPEulerSampler":
        "{num_steps: 50, guidance: 1.5, scheduler: src.diffusion.ddpm.scheduling.VPScheduler, "
        "step_fn: sde}",
}


def _node(class_path, tmp_path):
    text = PORTED_NODES[class_path] % {
        "linear": "src.diffusion.flow_matching.scheduling.LinearScheduler"}
    path = tmp_path / "node.yaml"
    path.write_text(f"node:\n  class_path: {class_path}\n  init_args: {text}\n")
    return path


@pytest.mark.parametrize("class_path", sorted(PORTED_NODES))
def test_ported_class_path_instantiates_like_jax(class_path, tmp_path):
    path = str(_node(class_path, tmp_path))
    ours = registry.instantiate(registry.load_yaml(path)["node"])
    ref = jax_registry.instantiate(jax_registry.load_yaml(path)["node"])
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours).__module__.startswith("deco_tpu_torch.")
    if "scheduling" in class_path:
        t = np.linspace(0, 0.99, 16, dtype=np.float32) * (999 if "DDPM" in class_path else 1)
        np.testing.assert_allclose(ours.w(t), np.asarray(ref.w(t)), rtol=1e-5)
        return
    for k in ("num_steps", "guidance", "timesteps", "step_type", "exact_heun", "order",
              "solver_coeffs", "_ts"):
        if hasattr(ref, k):
            np.testing.assert_array_equal(getattr(ours, k), np.asarray(getattr(ref, k)), err_msg=k)
    assert type(ours.scheduler).__name__ == type(ref.scheduler).__name__


def test_t2i_production_sampler_node_instantiates_like_jax():
    """configs_t2i/sft_res512.yaml's AdamLMSampler, the sampler the port
    takes over from the t2i configs for the c2i net."""
    path = os.path.join(REPO, "configs_t2i/sft_res512.yaml")
    ours = registry.instantiate(registry.load_yaml(path)["model"]["diffusion_sampler"])
    ref = jax_registry.instantiate(jax_registry.load_yaml(path)["model"]["diffusion_sampler"])
    assert (ours.num_steps, ours.order, ours.guidance) == (ref.num_steps, ref.order, ref.guidance)
    np.testing.assert_array_equal(ours.solver_coeffs, ref.solver_coeffs)
    np.testing.assert_array_equal(ours._cfg_array(), ref._cfg_array())


TINY_T2I_DENOISER = dict(hidden_size=32, num_groups=2, num_encoder_blocks=2, num_text_blocks=1,
                         decoder_hidden_size=8, num_decoder_blocks=1)


@pytest.mark.parametrize("name", ["sft_res512", "pretraining_res256", "pretraining_res512"])
def test_t2i_configs_instantiate_like_jax(name):
    """Every configs_t2i/ denoiser node at a tiny width builds the port's
    DeCoT2I with the JAX model's fields; the text encoder node (its
    weight_path dropped, as in the JAX registry) the hash-embedding
    Qwen3TextEncoder of the same width and length."""
    path = os.path.join(REPO, "configs_t2i", f"{name}.yaml")
    ours, ref = registry.load_yaml(path), jax_registry.load_yaml(path)
    for config in (ours, ref):
        config["model"]["denoiser"]["init_args"].update(TINY_T2I_DENOISER)
    model_ref = jax_registry.instantiate(ref["model"]["denoiser"])
    node = ours["model"]["denoiser"]
    model = registry.instantiate({**node, "init_args": {**node["init_args"], "device": "cpu"}})
    assert type(model).__name__ == type(model_ref).__name__ == "DeCoT2I"
    assert model.dtype == torch.bfloat16
    assert (model.hidden_size, model.num_groups, model.patch_size, model.txt_max_length) == (
        model_ref.hidden_size, model_ref.num_groups, model_ref.patch_size,
        model_ref.txt_max_length)
    assert len(model.blocks) == model_ref.num_encoder_blocks
    assert len(model.text_refine_blocks) == model_ref.num_text_blocks
    assert len(model.dec_net.res_blocks) == model_ref.num_decoder_blocks
    assert model.y_embedder.proj.in_features == model_ref.txt_embed_dim
    assert model.dec_net.model_channels == model_ref.decoder_hidden_size
    assert model.decoder_chunks == model_ref.decoder_chunks
    enc = registry.instantiate(ours["model"]["conditioner"])
    enc_ref = jax_registry.instantiate(ref["model"]["conditioner"])
    assert type(enc).__name__ == type(enc_ref).__name__ == "Qwen3TextEncoder"
    assert (enc.embed_dim, enc.max_length, enc._model) == (
        enc_ref.embed_dim, enc_ref.max_length, None)


def test_t2i_full_width_node_is_deco_xxl():
    """sft_res512.yaml's denoiser as the CLI builds it: 1.12B parameters
    (built on the meta device, no memory)."""
    node = registry.load_yaml(os.path.join(REPO, "configs_t2i/sft_res512.yaml"))["model"][
        "denoiser"]
    model = registry._dit_t2i_deco_dispatch(**node["init_args"], device="meta")
    params = sum(p.numel() for p in model.parameters())
    assert 1.10e9 < params < 1.14e9, params
    assert model.hidden_size // model.num_groups == 64


def test_the_reco_branch_of_dit_t2i_deco_raises_its_roadmap_item():
    """The ReCo branch (``config_path``/``select_layer``) was ROADMAP §A 5a:
    it now builds ``ReCoModel`` (on the meta device here) with the default
    InternViT where the config directory is absent, cut to ``select_layer``."""
    from deco_tpu_torch.models.reco import ReCoModel

    for args, depth in (({"config_path": "./InternVL3-2B", "select_layer": -1}, 24),
                        ({"select_layer": 18}, 18)):
        model = registry.instantiate({"class_path": "src.models.transformer.dit_t2i_DeCo.PixNerDiT",
                                      "init_args": {**args, "device": "meta"}})
        assert type(model) is ReCoModel and len(model.vision_model.encoder.layers) == depth


def test_t2i_prompt_dataset_nodes_instantiate_like_jax():
    """sft_res512.yaml's eval (GenEval) and pred (DPG) dataset nodes."""
    path = os.path.join(REPO, "configs_t2i/sft_res512.yaml")
    ours, ref = registry.load_yaml(path)["data"], jax_registry.load_yaml(path)["data"]
    for key, name in (("eval_dataset", "GenEvalDataset"), ("pred_dataset", "DPGDataset")):
        a, b = registry.instantiate(ours[key]), jax_registry.instantiate(ref[key])
        assert type(a).__name__ == type(b).__name__ == name
        assert type(a).__module__.startswith("deco_tpu_torch.")
        assert len(a) == len(b) > 0 and a.latent_shape == b.latent_shape == (3, 512, 512)


METRICS_CONFIGS = [p for p in CONFIGS if "ComputeMetricsHook" in open(os.path.join(REPO, p)).read()]


@pytest.mark.parametrize("path", METRICS_CONFIGS)
def test_compute_metrics_callback_of_the_reco_configs_parses(path):
    """The callback node of the ReCo and VAE configs builds the port's hook
    with the arguments the JAX loop passes its own."""
    from deco_tpu.train.hooks import ComputeMetricsHook as JaxHook
    from deco_tpu_torch.train.hooks import ComputeMetricsHook

    callbacks = registry.load_yaml(os.path.join(REPO, path))["trainer"]["callbacks"]
    (node,) = [c for c in callbacks if c["class_path"].endswith("ComputeMetricsHook")]
    args = node.get("init_args") or {}
    hook, ref = ComputeMetricsHook(**args, device="cpu"), JaxHook(**args)
    assert (hook.compute_fid, hook._fid_dim, hook.data_range) == (
        ref.compute_fid, ref._fid_dim, ref.data_range)
    assert not hook.has_updates


# ---- CLI ----

@pytest.mark.parametrize("path", CONFIGS)
def test_cli_selects_the_workload_jax_selects(path):
    config = _pyyaml(path)
    assert cli.detect_workload(config) == jax_workloads.detect_workload(config)


@pytest.mark.parametrize("token", ["3", "-2", "1e-4", "0.5", "true", "False", "null", "None",
                                   "abc", "1e4x"])
def test_cli_parses_override_values_like_jax(token):
    assert cli._parse_value(token) == jax_cli._parse_value(token)
    assert type(cli._parse_value(token)) is type(jax_cli._parse_value(token))


def test_cli_routes_the_uniflow_configs(tmp_path, monkeypatch):
    """``fit`` and ``validate`` of a UniFlow config reach ``run_uniflow`` with
    the CLI's arguments (the workload raised here before it was ported)."""
    from deco_tpu_torch.train import workloads

    calls = []
    monkeypatch.setattr(workloads, "run_uniflow",
                        lambda config, **kw: calls.append((config["model"], kw)) or "ran")
    path = os.path.join(REPO, "configs_flow/uniflow_internvit_2b_base.yaml")
    for sub in ("fit", "validate"):
        assert cli.main([sub, "-c", path, "--device", "cpu", "--max_steps", "2",
                         f"--workdir={tmp_path}"]) == "ran"
    assert [kw["subcommand"] for _, kw in calls] == ["fit", "validate"]
    assert calls[0][1]["max_steps"] == 2 and calls[0][1]["workdir"] == str(tmp_path)
    assert calls[0][0]["config_path"] == "deco_tpu/models/uniflow/config.json"


def test_cli_without_a_card_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["predict", "-c", os.path.join(REPO, "configs_c2i/DeCo_XL.yaml"),
                  "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
