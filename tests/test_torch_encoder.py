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
    cfg = load_config([DQVAE_TINY])["model"]["params"]["encoderconfig"]
    enc = DualGrainEncoder(**dict(cfg["params"], update_router=True))
    with pytest.raises(NotImplementedError):
        enc(torch.zeros(1, 3, 64, 64), torch.zeros(1, 4, 4), train=True)
    # a router that takes no gradient trains; ResnetBlock dropout in training does not
    enc = DualGrainEncoder(**dict(cfg["params"], update_router=False))
    x = torch.zeros(1, 3, 64, 64, requires_grad=True)
    out = enc(x, torch.zeros(1, 4, 4), train=True)
    assert out["h_dual"].requires_grad
    with pytest.raises(NotImplementedError):
        DualGrainEncoder(**dict(cfg["params"], update_router=False, dropout=0.1))(
            x, torch.zeros(1, 4, 4), train=True)


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
    x = torch.zeros((1, 8, 8, 8), device=cuda_device)
    w, b = torch.zeros((8, 8, 3, 3), device=cuda_device), torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        strided_conv3x3_down(x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16))
    with pytest.raises(ValueError):
        strided_conv3x3_down(x.to(memory_format=torch.channels_last), w, b)
