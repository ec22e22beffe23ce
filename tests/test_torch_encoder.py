"""Stage-1 encode in the PyTorch port against the JAX package: `Downsample`,
both routers, `DualGrainEncoder`, `DualGrainVQModel.encode`/`forward`, the
permuter's pack, and `Dualformer.encode_to_z`, on the same weights (JAX
init perturbed from a numpy seed and carried over by the port's converter,
or the port's seeded init carried the other way by the JAX package's) and
the same NHWC inputs, f32. Features and images atol 1e-4; codes, grain
indices and code streams exact. On a CUDA card, `Downsample`'s kernel
against its plain version.

JAX, and the helpers shared with the other port tests, are imported inside
the tests, so the CUDA cases also run where only PyTorch is installed:
`python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models.permuter import DualGrainSeparatePermuter
from dynamicvectorquantization_torch.nn import blocks, routers
from dynamicvectorquantization_torch.nn.encoder_dual import DualGrainEncoder
from dynamicvectorquantization_torch.ops.downsample import (
    strided_conv3x3_down,
    strided_conv3x3_down_plain,
)
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables
from dynamicvectorquantization_torch.utils.weights import dqvae_state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DQVAE_TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
STAGE2_TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
ATOL = 1e-4
THRESHOLDS = "scripts/tools/thresholds/entropy_thresholds_imagenet_train_patch-16.json"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, b=2, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("with_conv", [True, False])
def test_downsample(with_conv):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn import blocks as jb
    from tests.test_torch_decoder import _block_state_dict, _from_torch, _jax_init, _nhwc, _to_torch

    x = _nhwc(0, (2, 9, 8, 16))  # an odd height reads the pad row
    jmod = jb.Downsample(16, with_conv=with_conv)
    tmod = blocks.Downsample(16, with_conv=with_conv)
    if with_conv:
        params = _jax_init(jmod, x)
        tmod.load_state_dict(_block_state_dict(params))
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    else:
        ref = np.asarray(jmod.apply({}, jnp.asarray(x)))
    with torch.no_grad():
        out = _from_torch(tmod(_to_torch(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# ----------------------------------------------------------------- routers
def test_fixed_entropy_router_thresholds():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.routers import DualGrainFixedEntropyRouter as JRouter

    entropy = np.random.default_rng(1).uniform(0, 3.4, size=(2, 4, 4)).astype(np.float32)
    for kw in ({"json_path": THRESHOLDS, "fine_grain_ratito": 0.5},
               {"json_path": THRESHOLDS, "fine_grain_ratio": 0.3},
               {"threshold": 1.5}):
        ref = np.asarray(JRouter(**kw).apply({}, entropy=jnp.asarray(entropy)))
        router = routers.DualGrainFixedEntropyRouter(**kw)
        out = router(entropy=torch.from_numpy(entropy)).numpy()
        np.testing.assert_array_equal(out, ref)
    # the port reads its own copy of the table
    assert os.path.dirname(routers.threshold_path(THRESHOLDS)) == routers.THRESHOLDS_DIR
    assert routers.load_threshold(THRESHOLDS, 0.5) == pytest.approx(1.6777750253677368)


@pytest.mark.parametrize("gate_type", ["1layer-fc", "2layer-fc-SiLu"])
@pytest.mark.parametrize("normalization_type", ["none", "group-4"])
def test_feature_router(gate_type, normalization_type):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.routers import DualGrainFeatureRouter as JRouter
    from tests.test_torch_decoder import _nhwc, _to_torch
    from tests.test_torch_stackgpt import perturbed

    c = 8
    h_fine, h_coarse = _nhwc(2, (2, 8, 8, c)), _nhwc(3, (2, 4, 4, c))
    jmod = JRouter(c, normalization_type, gate_type)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h_fine), jnp.asarray(h_coarse))["params"]
    params = perturbed(jax.device_get(params), np.random.default_rng(4), 0.05)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(h_fine), jnp.asarray(h_coarse)))
    router = routers.DualGrainFeatureRouter(c, normalization_type, gate_type)
    sd = dqvae_state_dict_from_flax({"params": {"encoder": {"router": params}}})
    router.load_state_dict({k[len("encoder.router."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = router(h_fine=_to_torch(h_fine), h_coarse=_to_torch(h_coarse)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------- the DQ-VAE
def _dqvae_config():
    cfg = load_config([DQVAE_TINY])["model"]
    cfg["params"]["lossconfig"] = None  # the GAN loss is not part of encode
    return cfg


@pytest.fixture(scope="module")
def dqvae_pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from tests.test_torch_stackgpt import perturbed

    cfg = _dqvae_config()
    jm = jinst(cfg)
    jvars = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    r = np.random.default_rng(5)
    params = perturbed(jvars["params"], r, 0.05)
    k, d = 64, 32
    codebook = (0.5 * r.normal(size=(k + 1, d))).astype(np.float32)
    codebook[k] = 0.0  # codes far apart, so the argmin is nowhere near a tie
    ema = {"quantize": {**jvars["ema"]["quantize"], "codebook": jnp.asarray(codebook)}}
    jvars = {"params": params, "ema": ema}
    tm = instantiate_from_config(cfg)
    tm.load_state_dict(dqvae_state_dict_from_flax(jvars))
    return jm, jvars, tm.eval()


def test_dual_grain_encoder(dqvae_pair):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy
    from tests.test_torch_decoder import _from_torch, _to_torch

    jm, jvars, tm = dqvae_pair
    x = _images(6)
    ent = jax_entropy(jnp.asarray(x), 16)
    ref = jm.net.apply(jvars, jnp.asarray(x), ent, method=lambda m, a, e: m.encoder(a, e))
    with torch.no_grad():
        out = tm.encoder(_to_torch(x), torch.from_numpy(np.array(ent)))
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref["indices"]))
    np.testing.assert_array_equal(out["gate"].numpy(), np.asarray(ref["gate"]))
    np.testing.assert_array_equal(out["codebook_mask"].numpy(), np.asarray(ref["codebook_mask"]))
    np.testing.assert_allclose(_from_torch(out["h_dual"]), np.asarray(ref["h_dual"]), atol=ATOL,
                               rtol=0)
    assert 0 < out["indices"].float().mean() < 1  # both grains


def test_encoder_gumbel_gate_waits_for_training_slice():
    """The Gumbel gate (train=True with update_router) is ported: it takes
    the caller's noise, or draws it from the generator (held to JAX in
    tests/test_torch_triple.py)."""
    cfg = load_config([DQVAE_TINY])["model"]["params"]["encoderconfig"]
    enc = DualGrainEncoder(**dict(cfg["params"], update_router=True))
    assert enc.gumbel_shape(1) == (1, 4, 4, 2)
    x = torch.zeros(1, 3, 64, 64, requires_grad=True)
    noise = torch.tensor([5.0, 0.0]).expand(1, 4, 4, 2)  # coarse wins everywhere
    out = enc(x, torch.ones(1, 4, 4) * 9.0, train=True, gumbel_noise=noise)
    assert out["h_dual"].requires_grad and int(out["indices"].sum()) == 0
    # the one-hot forward, up to (1 + s) - s rounding
    torch.testing.assert_close(out["gate"].detach(), torch.tensor([1.0, 0.0]).expand(1, 4, 4, 2),
                               atol=1e-6, rtol=0)
    drawn = [enc(x, torch.ones(1, 4, 4), train=True,
                 generator=torch.Generator().manual_seed(3))["gate"] for _ in range(2)]
    assert torch.equal(drawn[0], drawn[1])
    assert enc(x, torch.ones(1, 4, 4))["gate"].dtype == torch.int64  # inference: no gate
    # a router that takes no gradient trains, and so does ResnetBlock dropout, whose
    # masks come from the generator (held to JAX's masks in
    # tests/test_torch_stage1_options.py); without masks or a generator it raises
    enc = DualGrainEncoder(**dict(cfg["params"], update_router=False))
    x = torch.zeros(1, 3, 64, 64, requires_grad=True)
    out = enc(x, torch.zeros(1, 4, 4), train=True)
    assert out["h_dual"].requires_grad
    enc = DualGrainEncoder(**dict(cfg["params"], update_router=False, dropout=0.1))
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    masked = [enc(x, torch.zeros(1, 4, 4), train=True,
                  generator=torch.Generator().manual_seed(s))["h_dual"] for s in (4, 4, 5)]
    assert torch.equal(masked[0], masked[1]) and not torch.equal(masked[0], masked[2])
    assert not torch.equal(masked[0], enc(x, torch.zeros(1, 4, 4))["h_dual"])
    with pytest.raises(ValueError):
        enc(x, torch.zeros(1, 4, 4), train=True)


def test_dqvae_encode_and_forward(dqvae_pair):
    import jax.numpy as jnp

    jm, jvars, tm = dqvae_pair
    assert tm.use_entropy
    x = _images(7)
    quant_r, loss_r, info_r, grain_r, gate_r, ent_r = jm.encode(jvars, jnp.asarray(x))
    dec_r, diff_r, _, _, _ = jm.forward(jvars, jnp.asarray(x))
    with torch.no_grad():
        quant, loss, info, grain, gate, ent = tm.encode(torch.from_numpy(x))
        dec, diff, grain2, _, _ = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(info[2].numpy(), np.asarray(info_r[2]))
    np.testing.assert_array_equal(grain.numpy(), np.asarray(grain_r))
    np.testing.assert_array_equal(grain2.numpy(), np.asarray(grain_r))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(gate_r))
    np.testing.assert_allclose(ent.numpy(), np.asarray(ent_r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(quant.numpy(), np.asarray(quant_r), atol=ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(diff.item(), float(diff_r), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_r), atol=ATOL, rtol=0)
    assert dec.shape == (2, 64, 64, 3)


def test_encode_half_roundtrips_through_jax_export(dqvae_pair):
    from dynamicvectorquantization_tpu.utils.torch_ckpt import export_dqvae_state_dict

    _, jvars, tm = dqvae_pair
    ref = export_dqvae_state_dict(jvars)
    ours = dqvae_state_dict_from_flax(jvars)
    encode_half = sorted(k for k in ref if k.startswith(("encoder.", "quant_conv.")))
    assert encode_half and encode_half == sorted(
        k for k in ours if k.startswith(("encoder.", "quant_conv.")))
    for key in encode_half:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key], err_msg=key)
    assert sorted(tm.state_dict()) == sorted(ours)


# ---------------------------------------------------------------- permuter
@pytest.mark.parametrize("order", ["row-first", "region-first"])
def test_permuter_pack_matches_jax(order):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.permuter import DualGrainSeparatePermuter as JPerm

    kw = dict(coarse_hw=4, fine_hw=8, content_pad_code=64, content_eos_code=65,
              coarse_position_pad_code=16, coarse_position_eos_code=17,
              fine_position_pad_code=64, fine_position_eos_code=65, fine_position_order=order)
    r = np.random.default_rng(8)
    codes = r.integers(0, 64, size=(3, 8, 8))
    grain = r.integers(0, 2, size=(3, 4, 4))
    grain[0] = 0  # all coarse
    grain[1] = 1  # all fine
    ref = JPerm(**kw).forward(jnp.asarray(codes, jnp.int32), jnp.asarray(grain, jnp.int32))
    perm = DualGrainSeparatePermuter(**kw)
    out = perm.forward(torch.from_numpy(codes), torch.from_numpy(grain))
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    back = perm.forward_back(out["coarse_content"], out["fine_content"], out["coarse_position"],
                             out["fine_position"])
    coarse_up = torch.from_numpy(codes[:, ::2, ::2]).repeat_interleave(2, 1).repeat_interleave(2, 2)
    fine = torch.from_numpy(grain).repeat_interleave(2, 1).repeat_interleave(2, 2) == 1
    torch.testing.assert_close(back, torch.where(fine, torch.from_numpy(codes), coarse_up))


# -------------------------------------------------------------- encode_to_z
def test_encode_to_z_matches_jax():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    model, sd = load_model_and_variables(STAGE2_TINY, seed=0, device="cpu")
    cb = model.first_stage_model.quantize.codebook.weight
    with torch.no_grad():
        cb[:-1] = torch.from_numpy(
            (0.5 * np.random.default_rng(9).normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    fs = {k[len("first_stage_model."):]: v.numpy() for k, v in model.state_dict().items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(cb.shape[0] - 1, np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    jmodel = jinst(jload_config([STAGE2_TINY])["model"])
    x = _images(10, b=3)
    quant_r, streams_r = jmodel.encode_to_z({"first_stage": convert_dqvae_state_dict(fs)},
                                            jnp.asarray(x))
    quant, streams = model.encode_to_z(torch.from_numpy(x))
    np.testing.assert_allclose(quant.numpy(), np.asarray(quant_r), atol=ATOL, rtol=0)
    assert sorted(streams) == sorted(streams_r)
    for key in streams_r:
        np.testing.assert_array_equal(streams[key].numpy(), np.asarray(streams_r[key]),
                                      err_msg=key)
    n_coarse = int((streams["coarse_position"] < 16).sum())
    assert 0 < n_coarse < 3 * 16  # both grains
    # the streams decode back through the port's unpack
    img = model.decode_to_img(streams["coarse_content"], streams["fine_content"],
                              streams["coarse_position"], streams["fine_position"])
    assert img.shape == (3, 64, 64, 3) and bool(torch.isfinite(img).all())


# -------------------------------------------------- Downsample's gradient
def _downsample_case(shape, k, device="cpu"):
    r = np.random.default_rng(12)
    c = shape[1]
    x = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(r.uniform(-1, 1, size=(k, c, 3, 3)).astype(np.float32) / (9 * c) ** 0.5)
    b = torch.from_numpy(r.uniform(-0.1, 0.1, size=(k,)).astype(np.float32))
    ho, wo = (shape[2] - 2) // 2 + 1, (shape[3] - 2) // 2 + 1
    dy = torch.from_numpy(r.normal(size=(shape[0], k, ho, wo)).astype(np.float32))
    return [t.to(device).requires_grad_() for t in (x, w, b)], dy.to(device)


@pytest.mark.parametrize("shape,k", [((2, 6, 9, 12), 5), ((1, 4, 8, 8), 4)])
def test_downsample_function_backward_equals_autograd_of_the_plain_version(monkeypatch, shape, k):
    """The autograd Function's backward (the library's conv gradients on the
    padded input) with its CUDA forward replaced by the plain version."""
    from dynamicvectorquantization_torch.ops import downsample

    monkeypatch.setattr(downsample, "_launch", strided_conv3x3_down_plain)
    leaves, dy = _downsample_case(shape, k)
    out = downsample._StridedConvDown.apply(*leaves)
    ref_out = strided_conv3x3_down_plain(*leaves)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    grads = torch.autograd.grad(out, leaves, dy)
    ref = torch.autograd.grad(ref_out, leaves, dy)
    for a, b in zip(grads, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    # only the gradients asked for
    (dx,) = torch.autograd.grad(downsample._StridedConvDown.apply(*leaves), leaves[:1], dy)
    torch.testing.assert_close(dx, ref[0], atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 16, 33, 20), 24), ((2, 128, 64, 64), 128)])
def test_cuda_downsample_gradient_matches_plain(cuda_device, shape, k):
    leaves, dy = _downsample_case(shape, k, cuda_device)
    before = strided_conv3x3_down.launches
    grads = torch.autograd.grad(strided_conv3x3_down(*leaves), leaves, dy)
    assert strided_conv3x3_down.launches == before + 1
    ref = torch.autograd.grad(strided_conv3x3_down_plain(*leaves), leaves, dy)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)  # f32 sums of up to 2048 terms


# -------------------------------------------------------------------- cuda
@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 16, 33, 20), 24), ((8, 128, 64, 64), 128)])
def test_cuda_downsample_kernel_matches_plain(cuda_device, shape, k):
    r = np.random.default_rng(11)
    x = torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(cuda_device)
    c = shape[1]
    w = torch.from_numpy(r.uniform(-1, 1, size=(k, c, 3, 3)).astype(np.float32) / (9 * c) ** 0.5)
    b = torch.from_numpy(r.uniform(-0.1, 0.1, size=(k,)).astype(np.float32))
    w, b = w.to(cuda_device), b.to(cuda_device)
    before = strided_conv3x3_down.launches
    out = strided_conv3x3_down(x, w, b)
    torch.cuda.synchronize()
    assert strided_conv3x3_down.launches == before + 1
    torch.testing.assert_close(out, strided_conv3x3_down_plain(x, w, b), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_downsample_rejects_what_the_kernel_cannot_take(cuda_device):
    """bf16 is the kernel's own dtype now (a bf16 case of the kernel against
    its plain version); float16, mixed dtypes and channels-last still raise."""
    x = torch.zeros((1, 8, 8, 8), device=cuda_device)
    w, b = torch.zeros((8, 8, 3, 3), device=cuda_device), torch.zeros(8, device=cuda_device)
    r = np.random.default_rng(13)
    x16, w16, b16 = (torch.from_numpy(r.normal(size=tuple(t.shape)).astype(np.float32))
                     .to(cuda_device, torch.bfloat16) for t in (x, w, b))
    before = strided_conv3x3_down.bf16_launches
    out = strided_conv3x3_down(x16, w16, b16)
    torch.cuda.synchronize()
    assert strided_conv3x3_down.bf16_launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), strided_conv3x3_down_plain(x16, w16, b16).float(),
                               atol=2e-2, rtol=2.0 ** -7)  # one bf16 rounding each
    with pytest.raises(TypeError):
        strided_conv3x3_down(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        strided_conv3x3_down(x16, w, b)
    with pytest.raises(ValueError):
        strided_conv3x3_down(x.to(memory_format=torch.channels_last), w, b)


# ------------------------------------------------- the blocked f32 Downsample
@pytest.mark.parametrize("dtype,c,blocked", [(torch.float32, 128, True), (torch.float32, 256, True),
                                             (torch.float32, 4, True), (torch.float32, 12, True),
                                             (torch.float32, 6, False), (torch.float32, 3, False),
                                             (torch.bfloat16, 128, False)])
def test_downsample_f32_route_by_dtype_and_channels(dtype, c, blocked):
    """f32 with C a multiple of 4 -> the blocked f32 kernel; f32 with another
    C -> the FMA kernel; bf16 never. Decided before any launch, so CPU
    tensors show it."""
    from dynamicvectorquantization_torch.ops.downsample import uses_blocked_f32

    x = torch.zeros((1, c, 4, 4), dtype=dtype)
    w = torch.zeros((8, c, 3, 3), dtype=dtype)
    assert uses_blocked_f32(x, w) == blocked


def test_misaligned_f32_weights_raise_instead_of_taking_the_fma_kernel():
    """No fallback: f32 weights with C % 4 == 0 off a 16-byte boundary are
    refused, not sent to the FMA kernel."""
    from dynamicvectorquantization_torch.ops.downsample import uses_blocked_f32

    k, c = 8, 12
    misaligned = torch.zeros(1 + k * c * 9)[1:].view(k, c, 3, 3)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="must start on a 16-byte boundary"):
        uses_blocked_f32(torch.zeros((1, c, 4, 4)), misaligned)


@pytest.mark.parametrize("k,c", [(5, 4), (24, 12), (128, 128)])
def test_f32_weight_pack_plain_is_a_reindexing(k, c):
    """`pack_weight_f32_plain`: packed[3 u + v, c, k] = w[k, c, u, v], zeros
    past K up to the next multiple of 4."""
    from dynamicvectorquantization_torch.ops.downsample import pack_weight_f32_plain

    w = torch.from_numpy(np.random.default_rng(k).normal(size=(k, c, 3, 3)).astype(np.float32))
    packed = pack_weight_f32_plain(w)
    kp = -(-k // 4) * 4
    assert packed.shape == (9, c, kp) and packed.dtype == torch.float32
    for u in range(3):
        for v in range(3):
            for ci in range(c):
                assert torch.equal(packed[3 * u + v, ci, :k], w[:, ci, u, v])
    assert not bool(packed[:, :, k:].any())


@pytest.mark.parametrize("shape,k", [((2, 8, 17, 33), 5), ((1, 12, 20, 36), 24)])
def test_deinterleaved_taps_with_the_packed_weights_give_the_plain_version(shape, k):
    """The blocked f32 kernel's operands: the padded input split by column
    parity (output pixel j reads even column j, odd column j and even column
    j + 1) and the packed weights, summed over channels and taps, give the
    plain version (f32 sums in another order)."""
    from dynamicvectorquantization_torch.ops.downsample import pack_weight_f32_plain

    (x, w, b), _ = _downsample_case(shape, k)
    x, w, b = x.detach(), w.detach(), b.detach()
    ho, wo = (shape[2] - 2) // 2 + 1, (shape[3] - 2) // 2 + 1
    padded = torch.nn.functional.pad(x, (0, 1, 0, 1))
    even, odd = padded[..., 0::2], padded[..., 1::2]
    packed = pack_weight_f32_plain(w)[:, :, :k]
    out = b[None, :, None, None].expand(shape[0], k, ho, wo).clone()
    for u in range(3):
        rows = slice(u, u + 2 * ho - 1, 2)
        for v, cols in ((0, even[..., rows, :wo]), (1, odd[..., rows, :wo]),
                        (2, even[..., rows, 1:wo + 1])):
            out += torch.einsum("bchw,ck->bkhw", cols, packed[3 * u + v])
    torch.testing.assert_close(out, strided_conv3x3_down_plain(x, w, b), atol=1e-5, rtol=0)


def _fma_kernel(x, w, b):
    """The FMA kernel's entry (`csrc/strided_conv_down.cu`) called directly:
    the blocked kernel sums in its order."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    n, c, h, w_ = x.shape
    k = w.shape[0]
    out = torch.empty((n, k, (h - 2) // 2 + 1, (w_ - 2) // 2 + 1), device=x.device)
    err = cuda_lib.lib().dqvq_strided_conv_down(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, h, w_, k, 0,
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "fma kernel")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((8, 128, 256, 256), 128), ((8, 128, 128, 128), 128),
                                     ((8, 256, 64, 64), 256), ((8, 256, 32, 32), 256),
                                     ((2, 12, 33, 20), 5), ((1, 4, 9, 8), 24),
                                     ((2, 20, 18, 40), 130), ((3, 16, 34, 2), 64)])
def test_cuda_f32_blocked_downsample_matches_plain(cuda_device, shape, k):
    """f32 with C % 4 == 0 runs the blocked kernel (`f32_blocked_launches`):
    within 1e-4 of the plain version (cuDNN's f32 convolution, TF32 off) at
    the encoder's four levels and at ragged H, W and K, equal to the FMA
    kernel bit for bit (the same summation order), and the same twice."""
    (x, w, b), _ = _downsample_case(shape, k, cuda_device)
    x, w, b = x.detach(), w.detach(), b.detach()
    before = (strided_conv3x3_down.launches, strided_conv3x3_down.f32_blocked_launches)
    out = strided_conv3x3_down(x, w, b)
    again = strided_conv3x3_down(x, w, b)
    torch.cuda.synchronize()
    assert (strided_conv3x3_down.launches, strided_conv3x3_down.f32_blocked_launches) == (
        before[0] + 2, before[1] + 2)
    torch.testing.assert_close(out, strided_conv3x3_down_plain(x, w, b), atol=1e-4, rtol=0)
    assert torch.equal(out, _fma_kernel(x, w, b)) and torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_f32_pack_and_routes(cuda_device):
    """The pack kernel equals its plain version; f32 with C % 4 != 0 stays on
    the FMA kernel; misaligned f32 weights raise."""
    from dynamicvectorquantization_torch.ops.downsample import (
        pack_weight_f32,
        pack_weight_f32_plain,
    )

    for k, c in ((5, 4), (130, 20), (256, 256)):
        w = torch.randn((k, c, 3, 3), device=cuda_device)
        assert torch.equal(pack_weight_f32(w), pack_weight_f32_plain(w))
    (x, w, b), _ = _downsample_case((2, 6, 17, 20), 8, cuda_device)
    before = (strided_conv3x3_down.launches, strided_conv3x3_down.f32_blocked_launches)
    out = strided_conv3x3_down(x.detach(), w.detach(), b.detach())
    torch.cuda.synchronize()
    assert (strided_conv3x3_down.launches, strided_conv3x3_down.f32_blocked_launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(out, strided_conv3x3_down_plain(x, w, b), atol=1e-4, rtol=0)
    w = torch.zeros(1 + 8 * 8 * 9, device=cuda_device)[1:].view(8, 8, 3, 3)
    with pytest.raises(ValueError, match="16-byte"):
        strided_conv3x3_down(torch.zeros((1, 8, 8, 8), device=cuda_device), w,
                             torch.zeros(8, device=cuda_device))
