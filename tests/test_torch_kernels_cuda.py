"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``cuda`` marker and skip without a CUDA device. They
import neither JAX nor the JAX package, so they also run on a GPU host that
has no JAX; there, run them without the repository's conftest (which clears
JAX caches):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances:
- attention outputs, atol 3e-2 between the bf16 kernel and the plain
  version (both round the output to bf16 and round P to bf16 against
  different maxima); lse, atol 1e-3 (fp32 sums of exact bf16 products, in
  another order);
- attention gradients, max abs error under 2e-2 of the largest plain value:
  the kernels round P and dS to bf16 before their products, as the TPU
  kernels do, where the plain version keeps fp32, and the outputs are bf16;
  delta, under 1e-4 of the largest plain value (fp32 sums of D exact
  products of bf16 values, in another order); the backward is bit-identical
  from run to run (no atomics);
- the frequency MSE, rtol 1e-4 (fp32 sums of ~6M terms in another order),
  and bit-identical from run to run;
- the causal instantiations, as the non-causal kernels, the output's
  atol in units of max(1, |plain|) (a causal row's first queries average
  one to a few values, outputs reach ~4.5, where one bf16 step is 2^-5);
- the fp32 forward (the DINOv2 tower's, D = 64, and the DC-AE's, D = 32),
  atol 1e-5 x max|v|: the kernel's 3xTF32 products carry about 2^-22 of
  relative error each (tests/test_torch_fp32_split.py), the plain version's
  fp32 ones (TF32 off) less, and both keep P in fp32.
"""

import pytest
import torch

from deco_tpu_torch.ops import block_dct
from deco_tpu_torch.ops import flash_attention as fa

ATOL = 3e-2
LSE_ATOL = 1e-3
BWD_REL = 2e-2
DELTA_REL = 1e-4
FREQ_RTOL = 1e-4

ATTN_SHAPES = [  # (B, Nq, Nkv, H, D), as chip_smoke.py: training, ragged, cross, D 64/128, long
    (32, 256, 256, 16, 72), (2, 200, 200, 16, 72), (2, 256, 333, 16, 72),
    (4, 256, 256, 16, 64), (2, 256, 256, 8, 128), (1, 4096, 4096, 16, 72),
]
T2I_TRAIN_SHAPES = [(16, 1024, 1152, 24, 64), (16, 1020, 1148, 24, 64), (16, 128, 128, 24, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, b, nq, nkv, h, d, seed=6):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
            for shape in ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d), (b, nq, h, d))]


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nkv,h,d", [
    (16, 256, 256, 16, 72), (2, 200, 200, 4, 72), (2, 256, 333, 4, 72),
    (2, 256, 256, 4, 64), (1, 130, 130, 2, 128), (1, 4096, 4096, 2, 72),
    (2, 130, 333, 2, 128),  # D = 128, ragged and Nq != Nkv
    (12, 1024, 1024, 16, 72),  # DeCo-XL/16 512 px, CFG at batch 6: B*H = 192
    # DeCo-XXL/16 t2i at 512 px, CFG at batch 1: joint (N + 128 text keys), text refine
    (2, 1024, 1152, 24, 64), (2, 128, 128, 24, 64),
    (1, 1020, 1148, 4, 64),  # 544x480 canvas: Nq and Nkv both ragged
])
def test_kernel_matches_plain_on_card(cuda_device, b, nq, nkv, h, d):
    q, k, v, _ = _qkv(cuda_device, b, nq, nkv, h, d)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < ATOL


@pytest.mark.cuda
def test_kernel_reads_strided_qkv_on_card(cuda_device):
    """q/k/v as views into one (B, N, 3, H, D) projection, as RAttention passes them."""
    qkv = torch.randn(2, 256, 3, 16, 72, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < ATOL


@pytest.mark.cuda
def test_t2i_model_runs_the_kernel_at_joint_and_text_shapes_on_card(cuda_device):
    """A 2 joint + 1 text block DeCoT2I at full width (hidden 1536, 24 heads
    of 64) on a 544x480 canvas, whose 1,020 image tokens and 1,148 keys are
    both ragged: 3 launches a call, finite, and within the slice gate of the
    same model on the CPU (both bf16)."""
    from deco_tpu_torch.models.dit_c2i_deco import init_random_
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    kw = dict(num_encoder_blocks=2, num_text_blocks=1)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 544, 480, 3, generator=gen)
    y = torch.randn(2, 128, 2048, generator=gen) * 0.02
    t = torch.tensor([0.3, 0.8])
    outs = {}
    for device in ("cuda", "cpu"):
        model = init_random_(DeCoT2I(**kw, device=device), seed=0).eval()
        before = fa.flash_attention.launches
        with torch.no_grad():
            outs[device] = model(x.to(device), t.to(device), y.to(device)).cpu()
        assert fa.flash_attention.launches - before == (3 if device == "cuda" else 0)
    assert bool(torch.isfinite(outs["cuda"]).all())
    rel = ((outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()).item()
    assert rel < 0.03, rel


@pytest.mark.cuda
def test_fwd_lse_reads_strided_qkv_on_card(cuda_device):
    """The forward with lse on q/k/v views into one (B, N, 3, H, D) projection."""
    qkv = torch.randn(2, 200, 3, 16, 72, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 72 ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
    assert (o.float() - o_ref.float()).abs().max().item() < ATOL
    assert (lse - lse_ref).abs().max().item() < LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 256, 16, 72), ATTN_SHAPES[-1]])  # sampling, N = 4096
def test_forward_is_bit_identical_on_card(cuda_device, shape):
    q, k, v, _ = _qkv(cuda_device, *shape)
    first, second = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
    (o1, lse1), (o2, lse2) = (fa.flash_attention_fwd_lse(q, k, v, 0.1) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.cuda
def test_nonpositive_scale_raises_on_card(cuda_device):
    q, k, v, _ = _qkv(cuda_device, 1, 64, 64, 2, 72)
    with pytest.raises(ValueError, match="scale must be positive"):
        fa.flash_attention(q, k, v, scale=-0.1)


def _backward(q, k, v, o, lse, do, scale, causal=False):
    """(dQ, delta, dK, dV) from the two backward kernels."""
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, causal)
    return (dq, delta, *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES + [
    (2, 130, 333, 2, 128),  # D = 128, ragged and Nq != Nkv: the largest shared-memory variant
    (16, 1024, 1024, 16, 72),  # DeCo-XL/16 512 px training, microbatch 16: B*H = 256
    # DeCo-XXL/16 t2i training, microbatch 16 (D = 64): joint (1,024 queries
    # over 1,024 image + 128 text keys), a 544x480 canvas, the text refinement
    *T2I_TRAIN_SHAPES,
])
def test_fwd_lse_and_backward_match_plain_on_card(cuda_device, shape):
    q, k, v, do = _qkv(cuda_device, *shape)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
    assert (o.float() - o_ref.float()).abs().max().item() < ATOL
    assert (lse - lse_ref).abs().max().item() < LSE_ATOL
    dq, delta, dk, dv = _backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    dq_ref, delta_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    assert delta.shape == delta_ref.shape and _rel(delta, delta_ref) < DELTA_REL
    for out, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        assert _rel(out, ref) < BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [ATTN_SHAPES[0], ATTN_SHAPES[-1],  # training, N = 4096
                                   T2I_TRAIN_SHAPES[0]])  # the t2i joint attention
def test_backward_is_bit_identical_on_card(cuda_device, shape):
    q, k, v, do = _qkv(cuda_device, *shape)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
    first = _backward(q, k, v, o, lse, do, scale)
    second = _backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_autograd_runs_the_kernels_on_card(cuda_device, monkeypatch):
    """Under autograd the wrapper takes the forward-with-lse and both backward
    kernels, with delta inside the dQ kernel (no torch op), and gradients
    reach q, k and v (v a strided view)."""
    def no_delta_op(*_):
        raise AssertionError("delta ran as a torch op on the card")

    monkeypatch.setattr(fa, "attention_delta", no_delta_op)
    qkv = torch.randn(2, 256, 3, 4, 72, device=cuda_device, dtype=torch.bfloat16,
                      requires_grad=True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    counts = [f.launches for f in (fa.flash_attention, fa.flash_attention_fwd_lse,
                                   fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    after = [f.launches for f in (fa.flash_attention, fa.flash_attention_fwd_lse,
                                  fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, counts)] == [0, 1, 1, 1]
    ref = qkv.detach().clone().requires_grad_(True)
    fa.flash_attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2]).float().square().sum().backward()
    assert _rel(qkv.grad, ref.grad) < BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256, 256, 3), (2, 16, 2048, 3), (1, 8, 200, 3),
                                   (3, 24, 520, 3)])
def test_freq_mse_matches_plain_and_repeats_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    diff = torch.randn(shape, generator=gen, device=cuda_device)
    w = block_dct.build_freq_weight()
    before = block_dct.freq_mse.launches
    first, second = block_dct.freq_mse(diff, w), block_dct.freq_mse(diff, w)
    torch.cuda.synchronize()
    assert block_dct.freq_mse.launches == before + 2
    assert torch.equal(first, second)
    ref = block_dct.frequency_weighted_mse_plain(diff, w)
    torch.testing.assert_close(first, ref, rtol=FREQ_RTOL, atol=0)


@pytest.mark.cuda
def test_freq_mse_unaligned_raises_on_card(cuda_device):
    with pytest.raises(ValueError, match="multiples of 8"):
        block_dct.freq_mse(torch.zeros(1, 12, 16, 3, device=cuda_device),
                           block_dct.build_freq_weight())


@pytest.mark.cuda
def test_freq_mse_misaligned_base_raises_on_card(cuda_device):
    diff = torch.zeros(8 * 16 * 3 + 1, device=cuda_device)[1:].view(1, 8, 16, 3)  # 4 bytes off
    assert diff.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        block_dct.freq_mse(diff, block_dct.build_freq_weight())


@pytest.mark.cuda
def test_fit_step_on_card(cuda_device):
    """One bf16-compute step of a 2-block full-width model through fit."""
    from deco_tpu_torch import fit

    result = fit.run("deco_xl_256", batch=2, steps=1, warmup=0, device="cuda",
                     num_cond_blocks=2, num_blocks=5)
    assert all(map(lambda x: x == x and abs(x) < float("inf"), result["losses"]))
    assert result["grad_norms"][0] > 0


def _png_folder(root, classes=2, per_class=2):
    """A PNG image folder written with the port's encoder (the card's host has no PIL)."""
    import numpy as np

    from deco_tpu_torch.utils import png

    rng = np.random.default_rng(0)
    for c in range(classes):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(per_class):
            png.write(str(root / f"c{c}" / f"{i}.png"),
                      rng.integers(0, 256, (288, 320, 3), dtype=np.uint8))
    return str(root)


CUT_DEPTH = ["--model.denoiser.init_args.num_cond_blocks=2",
             "--model.denoiser.init_args.num_blocks=5"]
KERNELS = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
           block_dct.freq_mse, fa.flash_attention)


def _cli_args(tmp):
    import os

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs_c2i", "DeCo_XL_freq.yaml")
    return ["-c", config, *CUT_DEPTH, f"--trainer.default_root_dir={tmp / 'work'}"]


@pytest.fixture(scope="module")
def cli_fit_on_card(tmp_path_factory):
    """DeCo_XL_freq.yaml through the CLI at full width with a 2-block trunk:
    two train steps at batch 2; the kernels' launches during the fit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU and nvcc")
    from deco_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("cli")
    for f in KERNELS:
        f.launches = 0
    cli.main(["fit", *_cli_args(tmp), "--max_steps", "2", "--data.train_batch_size=2",
              f"--data.train_dataset.init_args.root={_png_folder(tmp / 'images')}",
              "--trainer.log_every_n_steps=1"])
    torch.cuda.synchronize()
    return tmp, [f.launches for f in KERNELS]


@pytest.mark.cuda
def test_cli_fit_runs_the_kernels_on_card(cli_fit_on_card):
    """Per step, with full remat: 4 forward-with-lse, 2 dQ, 2 dK/dV and 1
    frequency-MSE launches; finite losses and a checkpoint."""
    import json

    import numpy as np

    tmp, launches = cli_fit_on_card
    assert launches == [8, 4, 4, 2, 0]
    workdir = tmp / "work" / "DeCo_256_XL_freq"
    losses = [json.loads(line)["loss"] for line in open(workdir / "metrics.jsonl")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (workdir / "checkpoints" / "2.pt").exists()


@pytest.mark.cuda
def test_cli_predict_runs_the_kernels_on_card(cli_fit_on_card):
    """One predict batch of 2 from the fit's checkpoint, 3 Euler steps: one
    forward launch per block and network call, and a uint8 output.npz."""
    import numpy as np

    from deco_tpu_torch import cli

    tmp, _ = cli_fit_on_card
    for f in KERNELS:
        f.launches = 0
    checkpoints = tmp / "work" / "DeCo_256_XL_freq" / "checkpoints"
    out = cli.main(["predict", *_cli_args(tmp), f"--ckpt_path={checkpoints}",
                    "--max_batches", "1", "--data.pred_batch_size=2",
                    "--model.diffusion_sampler.init_args.num_steps=3"])
    assert [f.launches for f in KERNELS] == [0, 0, 0, 0, 2 * 3]
    images = np.load(out)["arr_0"]
    assert images.shape == (2, 256, 256, 3) and images.dtype == np.uint8 and images.std() > 0


def _tiny_c2i(device, **kw):
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_random_

    model = DeCoC2I(in_channels=3, patch_size=16, num_groups=16, hidden_size=1152,
                    hidden_size_x=32, num_blocks=5, num_cond_blocks=2, num_classes=1000,
                    param_dtype=torch.float32, grad_checkpoint=True, device=device, **kw)
    return init_random_(model, 0).train()


@pytest.mark.cuda
@pytest.mark.parametrize("policy, per_block", [("full", 2), ("dots", 2), ("attn", 1)])
def test_remat_policy_launches_and_gradients_on_card(cuda_device, policy, per_block):
    """A 2-block full-width trunk at 512 px with decoder_chunks 8: under
    "attn" the backward takes the kept (o, lse), so the forward with lse
    launches once per block; every policy gives the gradients of "none"
    (the same kernels on the same inputs: bit-equal)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 512, 512, 3, generator=gen, device=cuda_device)
    t, y = torch.tensor([0.3, 0.8], device=cuda_device), torch.tensor([5, 1000], device=cuda_device)
    grads = []
    for name in ("none", policy):
        model = _tiny_c2i(cuda_device, trunk_remat_policy=name, decoder_chunks=8)
        before = fa.flash_attention_fwd_lse.launches
        model(x, t, y).float().square().mean().backward()
        torch.cuda.synchronize()
        launches = fa.flash_attention_fwd_lse.launches - before
        grads.append([p.grad for p in model.parameters()])
    assert launches == per_block * 2
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_inception_features_match_the_cpu_on_card(cuda_device):
    """The FID tower on the card (fp32, TF32 off) against the same tower on
    the CPU: features within 1e-4 of their largest value."""
    import numpy as np

    from deco_tpu_torch.models import inception

    tower = inception.random_inception(0, device="cpu")
    images = np.random.default_rng(0).uniform(0, 1, (4, 512, 512, 3)).astype(np.float32)
    ref = inception.compute_fid_features(images, tower)
    got = inception.compute_fid_features(images, tower.to(cuda_device))
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
def test_t2i_train_step_launches_and_remat_gradients_on_card(cuda_device):
    """A 2 joint + 1 text block DeCoT2I at full width, one sft_res512.yaml
    loss and backward at batch 2 on a 544x480 canvas: 3 dQ and 3 dK/dV
    launches, the forward with lse 3 times without grad_checkpoint and 6
    times with it (each block recomputed), the same gradients both ways
    (the same kernels on the same inputs: bit-equal), and non-zero
    gradients on the text side, which only the text half of dK/dV reaches."""
    from deco_tpu_torch.diffusion.scheduling import LinearScheduler
    from deco_tpu_torch.diffusion.training import DeCoTrainer
    from deco_tpu_torch.models.dit_c2i_deco import init_random_
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.rand(2, 544, 480, 3, generator=gen, device=cuda_device) * 2 - 1
    cond = torch.randn(2, 128, 2048, generator=gen, device=cuda_device) * 0.02
    draws = dict(drop_u=[0.9, 0.5], t_normal=[0.3, -0.7], t_uniform=[0.2, 0.6], mix_u=[0.5, 0.95],
                 noise=torch.randn(2, 544, 480, 3, generator=gen, device=cuda_device))
    trainer = DeCoTrainer(LinearScheduler(), lognorm_t=True, timeshift=4.0)
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    grads, counts = [], []
    for gc in (False, True):
        model = init_random_(DeCoT2I(num_encoder_blocks=2, num_text_blocks=1,
                                     param_dtype=torch.float32, grad_checkpoint=gc,
                                     device=cuda_device), seed=0).train()
        before = [f.launches for f in kernels]
        trainer(model, x, cond, torch.zeros_like(cond), draws=draws)["loss"].backward()
        torch.cuda.synchronize()
        counts.append([f.launches - b for f, b in zip(kernels, before)])
        grads.append(dict((n, p.grad) for n, p in model.named_parameters()))
    assert counts == [[3, 3, 3], [6, 3, 3]]
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    for name in ("blocks.0.attn.kv_y.weight", "blocks.1.attn.kv_y.weight",
                 "text_refine_blocks.0.attn.qkv.weight", "y_embedder.proj.weight",
                 "y_pos_embedding"):
        assert bool(torch.isfinite(grads[0][name]).all()) and grads[0][name].abs().max() > 0, name


F32_SHAPES = [  # (B, N, H, D): the DINOv2 tower (D 64), the DC-AE's attention (D 32)
    (2, 17, 3, 64), (32, 257, 12, 64), (4, 1025, 12, 64),
    (2, 64, 32, 32), (4, 1024, 16, 32), (2, 17, 3, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", F32_SHAPES)
def test_fp32_forward_matches_plain_and_repeats_on_card(cuda_device, b, n, h, d):
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=cuda_device) for _ in range(3))
    before = fa.flash_attention_fwd_f32.launches
    out, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_f32.launches == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again)
    err = (out - fa.flash_attention_plain(q, k, v)).abs().max().item()
    assert err <= 1e-5 * v.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_fp32_kernel_info_reports_no_spills_on_card(cuda_device, d):
    """The 3xTF32 kernel at D = 32 and 64: no local memory, at least two
    resident CTAs an SM, and the build log's ptxas report without spills."""
    from deco_tpu_torch.ops import _build

    info = fa.forward_kernel_info(d)["flash_fwd_f32_kernel"]
    assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 2, info
    report = _build.ptxas_report((_build.BUILD_DIR / "flash_attention_fwd.log").read_text())
    rows = [r for name, r in report.items() if f"flash_fwd_f32_kernelILi{d}E" in name]
    assert len(rows) == 1 and rows[0]["spill_store_bytes"] == 0, rows


@pytest.mark.cuda
def test_fp32_lse_and_backward_raise_on_card(cuda_device):
    q = torch.randn(1, 17, 1, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(TypeError, match="forward kernel only"):
        fa.flash_attention_fwd_lse(q.detach(), q.detach(), q.detach(), 0.125)
    with pytest.raises(TypeError, match="forward kernel only"):
        fa.flash_attention(q, q, q)  # under autograd: the training path
    lse = torch.zeros(1, 1, 17, device=cuda_device)
    with pytest.raises(TypeError, match="needs bfloat16"):
        fa.flash_attention_bwd(*(q.detach(),) * 4, lse, q.detach(), 0.125)


@pytest.mark.cuda
def test_bf16_forward_unchanged_beside_fp32_on_card(cuda_device):
    """bf16 operands still take the tensor-core kernel (its own count)."""
    q, k, v, _ = _qkv(cuda_device, 2, 257, 257, 12, 64)
    counts = (fa.flash_attention.launches, fa.flash_attention_fwd_f32.launches)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_fwd_f32.launches) == (
        counts[0] + 1, counts[1])
    assert out.dtype == torch.bfloat16
    assert (out.float() - fa.flash_attention_plain(q, k, v).float()).abs().max() < ATOL


@pytest.mark.cuda
def test_dinov2_tower_runs_the_fp32_kernel_on_card(cuda_device):
    """A 2-layer random DINOv2 at full width: 2 fp32 launches, features
    within 1e-4 (relative L2) of the CPU's."""
    import warnings

    from deco_tpu_torch.models.encoders import DINOv2

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        towers = [DINOv2(num_layers=2, device=dev) for dev in ("cpu", cuda_device)]
    raw = torch.rand(4, 256, 256, 3, generator=torch.Generator().manual_seed(0))
    before = fa.flash_attention_fwd_f32.launches
    with torch.no_grad():
        card = towers[1](raw.to(cuda_device)).cpu()
        cpu = towers[0](raw)
    assert fa.flash_attention_fwd_f32.launches == before + 2
    assert card.shape == (4, 256, 768)
    assert ((card - cpu).norm() / cpu.norm()).item() < 1e-4


# ReCo (ReCo_large.yaml): the InternViT tower (N = 16^2 + 1 = 257) and the
# pixel decoder's blocks (16 learnable + 256 latent tokens = 272) at the
# shipped fit batch 16 x diffusion_batch_mul 4, 16 heads of 64; both lengths
# ragged (257 leaves one row in the last 64-row tile)
RECO_SHAPES = [(64, 257, 257, 16, 64), (64, 272, 272, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RECO_SHAPES, ids=["tower_257", "decoder_272"])
def test_reco_shapes_forward_and_backward_match_plain_on_card(cuda_device, shape):
    """Rows 1, 3, 5 and 6 at the ReCo shapes: the forward, the forward with
    lse, dQ (with delta) and dK/dV against their plain versions, and the
    backward bit-identical over two runs."""
    q, k, v, do = _qkv(cuda_device, *shape)
    scale = shape[-1] ** -0.5
    out = fa.flash_attention(q, k, v, scale)
    assert (out.float() - fa.flash_attention_plain(q, k, v, scale).float()).abs().max() < ATOL
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
    assert torch.equal(o, out) and (o.float() - o_ref.float()).abs().max().item() < ATOL
    assert (lse - lse_ref).abs().max().item() < LSE_ATOL
    dq, delta, dk, dv = _backward(q, k, v, o, lse, do, scale)
    again = _backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    dq_ref, delta_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    assert _rel(delta, delta_ref) < DELTA_REL
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        assert _rel(got, ref) < BWD_REL
    assert all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again))


@pytest.mark.cuda
def test_reco_model_runs_the_kernels_on_card(cuda_device):
    """A full-width ReCo cut to a 2-layer tower and 1 decoder block, bf16:
    a sampling call takes 3 forward launches and a training step 3 of each
    training kernel, with every parameter of the tower given a gradient."""
    from deco_tpu_torch.diffusion.scheduling import LinearScheduler
    from deco_tpu_torch.diffusion.training import DeCoTrainer
    from deco_tpu_torch.models.reco import ReCoModel

    model = ReCoModel(hidden_size=1024, num_groups=16, hidden_size_x=32, num_encoder_blocks=1,
                      num_decoder_blocks=3, select_layer=2, param_dtype=torch.float32,
                      device=cuda_device)
    model.init_like_jax_(0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    image = torch.rand(4, 224, 224, 3, generator=gen, device=cuda_device) * 2 - 1
    kernels = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    with torch.no_grad():
        out = model(torch.randn(image.shape, generator=gen, device=cuda_device),
                    torch.full((4,), 0.5, device=cuda_device), image.bfloat16())
    assert out.shape == image.shape and bool(torch.isfinite(out).all())
    trainer = DeCoTrainer(LinearScheduler(), lognorm_t=True, null_condition_p=0.0)
    cond = image.bfloat16()
    trainer(model, image, cond, torch.zeros_like(cond), generator=gen)["loss"].backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [3, 3, 3, 3]
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.vision_model.parameters())


# The DC-AE decoder's attention in the bf16 VAE-GAN (D = 32): at 224 px the
# three attention stages attend over 8^2, 16^2 and 32^2 tokens (32, 32 and
# 16 heads), at the fit batch 8; a 256 px validate pads to 280 px, so 10^2,
# 20^2 and 40^2 tokens (ragged); 448 px reaches 64^2
D32_SHAPES = [(8, 64, 64, 32, 32), (8, 256, 256, 32, 32), (8, 1024, 1024, 16, 32),
              (4, 100, 100, 32, 32), (4, 400, 400, 32, 32), (4, 1600, 1600, 16, 32),
              (2, 4096, 4096, 16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", D32_SHAPES, ids=lambda s: f"d32_n{s[1]}")
def test_d32_bf16_forward_and_backward_match_plain_on_card(cuda_device, shape):
    """The bf16 kernels at D = 32: the forward, the forward with lse, dQ
    (with delta) and dK/dV against their plain versions, the forward and
    the backward bit-identical over two runs."""
    q, k, v, do = _qkv(cuda_device, *shape)
    scale = shape[-1] ** -0.5
    before = fa.flash_attention.launches
    out, again = fa.flash_attention(q, k, v, scale), fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2 and torch.equal(out, again)
    assert (out.float() - fa.flash_attention_plain(q, k, v, scale).float()).abs().max() < ATOL
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
    assert torch.equal(o, out) and (o.float() - o_ref.float()).abs().max().item() < ATOL
    assert (lse - lse_ref).abs().max().item() < LSE_ATOL
    dq, delta, dk, dv = _backward(q, k, v, o, lse, do, scale)
    repeat = _backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    dq_ref, delta_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    assert _rel(delta, delta_ref) < DELTA_REL
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        assert _rel(got, ref) < BWD_REL
    assert all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), repeat))


@pytest.mark.cuda
def test_d32_kernel_info_reports_no_spills_on_card(cuda_device):
    """The four bf16 instantiations at D = 32: no local memory, and the
    resident CTAs the D <= 72 sizing is compiled for (2 forward, 3 backward)."""
    infos = {**fa.forward_kernel_info(32), **fa.backward_kernel_info(32)}
    assert set(infos) >= {"flash_fwd_kernel", "flash_fwd_kernel_lse", "flash_bwd_dq_kernel",
                          "flash_bwd_dkv_kernel"}, infos
    for name in ("flash_fwd_kernel", "flash_fwd_kernel_lse"):
        assert infos[name]["local_bytes"] == 0 and infos[name]["ctas_per_sm"] >= 2, infos[name]
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert infos[name]["local_bytes"] == 0 and infos[name]["ctas_per_sm"] >= 3, infos[name]


@pytest.mark.cuda
def test_d32_autograd_through_strided_qkv_on_card(cuda_device):
    """A DC-AE attention block's call: q, k, v views into one (B, N, 3, H, 32)
    projection under autograd take the forward with lse and both backward
    kernels, gradients within the backward tolerance of the plain version's."""
    qkv = torch.randn(2, 256, 3, 8, 32, device=cuda_device, dtype=torch.bfloat16,
                      requires_grad=True)
    kernels = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [0, 1, 1, 1]
    ref = qkv.detach().clone().requires_grad_(True)
    fa.flash_attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2]).float().square().sum().backward()
    assert _rel(qkv.grad, ref.grad) < BWD_REL


# UniFlow's causal semantic trunk (32 heads of 64, Nq = Nkv): 256 tokens at
# 448 px, 64 at 224 px, 1,024 at 896 px, and a ragged 100 (280 px / 28)
CAUSAL_SHAPES = [(16, 256, 256, 32, 64), (16, 64, 64, 32, 64), (2, 1024, 1024, 32, 64),
                 (16, 100, 100, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CAUSAL_SHAPES, ids=lambda s: f"causal_n{s[1]}")
def test_causal_forward_and_backward_match_plain_on_card(cuda_device, shape):
    """The causal instantiations: the forward, the forward with lse, dQ (with
    delta) and dK/dV against their plain versions, which mask key > query,
    under the gates of the non-causal holds, bit-identical over two runs;
    each counts in ``causal_launches`` and not in ``launches``."""
    q, k, v, do = _qkv(cuda_device, *shape)
    scale = shape[-1] ** -0.5
    kernels = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    plain_before = [f.launches for f in kernels]
    before = [f.causal_launches for f in kernels]
    out = fa.flash_attention(q, k, v, scale, causal=True)
    again = fa.flash_attention(q, k, v, scale, causal=True)
    assert torch.equal(out, again)
    ref = fa.flash_attention_plain(q, k, v, scale, causal=True)
    # in units of max(1, |plain|): a row's first queries average few values
    # (|o| up to ~4.5, where one bf16 step is 2^-5)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)).max() < ATOL
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale, causal=True)
    assert torch.equal(o, out) and (lse - lse_ref).abs().max().item() < LSE_ATOL
    dq, delta, dk, dv = _backward(q, k, v, o, lse, do, scale, causal=True)
    repeat = _backward(q, k, v, o, lse, do, scale, causal=True)
    torch.cuda.synchronize()
    dq_ref, delta_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale, causal=True)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                                      causal=True)
    assert _rel(delta, delta_ref) < DELTA_REL
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rel(got, want) < BWD_REL
    assert all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), repeat))
    assert [f.causal_launches - b for f, b in zip(kernels, before)] == [2, 1, 2, 2]
    assert [f.launches for f in kernels] == plain_before


@pytest.mark.cuda
def test_causal_autograd_and_the_refusals_on_card(cuda_device):
    """``sdpa(causal=True)`` under autograd takes the causal forward with lse
    and both causal backward kernels, gradients within the backward gate of
    the plain version's; Nq != Nkv, a head dim without a causal
    instantiation and fp32 operands raise."""
    from deco_tpu_torch.models.layers import sdpa

    qkv = torch.randn(2, 100, 3, 32, 64, device=cuda_device, dtype=torch.bfloat16,
                      requires_grad=True)
    before = fa.flash_attention_bwd_dkv.causal_launches
    sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.causal_launches == before + 1
    ref = qkv.detach().clone().requires_grad_(True)
    fa.flash_attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2],
                             causal=True).float().square().sum().backward()
    assert _rel(qkv.grad, ref.grad) < BWD_REL
    q, k, v, _ = _qkv(cuda_device, 2, 64, 128, 4, 64)
    with pytest.raises(ValueError, match="Nq = Nkv"):
        fa.flash_attention(q, k, v, causal=True)
    q, k, v, _ = _qkv(cuda_device, 2, 64, 64, 4, 72)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q.float(), k.float(), v.float(), causal=True)


@pytest.mark.cuda
def test_causal_kernel_info_reports_no_spills_on_card(cuda_device):
    """The four causal instantiations at D = 64: no local memory, and the
    resident CTAs the non-causal ones are compiled for (2 forward, 3 backward)."""
    infos = {**fa.forward_kernel_info(64), **fa.backward_kernel_info(64)}
    for name in ("flash_fwd_kernel_causal", "flash_fwd_kernel_lse_causal"):
        assert infos[name]["local_bytes"] == 0 and infos[name]["ctas_per_sm"] >= 2, infos[name]
    for name in ("flash_bwd_dq_kernel_causal", "flash_bwd_dkv_kernel_causal"):
        assert infos[name]["local_bytes"] == 0 and infos[name]["ctas_per_sm"] >= 3, infos[name]


# The InternVL distillation teacher (UniFlow's distill configs): its tower
# runs the bf16 forward kernel at D = 64, one launch a layer (no grad). A
# 2-layer InternViT at full width (1,024, 16 heads of 64) written as the
# release lays it out (bf16 safetensors in two shards), a batch of 4 at
# 224 px (N = 257): features on the kernel against the plain attention path
# on the card, relative L2 under chip_smoke.TEACHER_GATE_REL_L2.
@pytest.mark.cuda
def test_teacher_runs_the_forward_kernel_and_matches_its_plain_path_on_card(cuda_device,
                                                                           tmp_path):
    import chip_smoke

    from deco_tpu_torch.models.uniflow import teacher as teacher_lib

    vision = dict(chip_smoke.TEACHER_VISION, num_hidden_layers=2)
    chip_smoke.write_teacher_folder(str(tmp_path), 3, vision=vision)
    teacher = teacher_lib.load_teacher_feature_fn(str(tmp_path), device=cuda_device)
    x = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    both = chip_smoke.teacher_on_kernel_and_plain(teacher, x.to(cuda_device))
    assert both["launches"] == 2 and both["plain_launches"] == 0
    assert both["kernel"]["vit_embeds"].shape == (4, 64, 4096)
    assert both["kernel"]["vit_embeds"].dtype == torch.bfloat16
    assert both["kernel"]["vit_embeds_mlp"].shape == (4, 64, chip_smoke.TEACHER_LLM)
    assert both["kernel"]["vit_embeds_mlp"].dtype == torch.float32
    assert max(both["rel_l2"].values()) < chip_smoke.TEACHER_GATE_REL_L2, both["rel_l2"]
