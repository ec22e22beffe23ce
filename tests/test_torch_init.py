"""The port's seeded DQ-VAE init draws what the JAX package's does.

For the three stage-1 model classes (the dual-grain model with the
fixed-entropy router, the dual-grain model with the Gumbel-gated feature
router, the triple-grain model) at tiny widths, the JAX model is
initialised, its parameters mapped onto the port's names by
`utils/weights.py` `dqvae_state_dict_from_flax`, and the port's
`init_weights` held to them per tensor: the same zero biases, standard
deviations within 10 % (tensors of >= 1,000 entries), and every conv /
linear kernel inside the +-2 sigma truncation of flax's `lecun_normal`.
"""
import math
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel, TripleGrainVQModel
from dynamicvectorquantization_torch.nn.init import _TRUNC_STD, lecun_normal_
from dynamicvectorquantization_torch.utils.weights import dqvae_state_dict_from_flax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
DUAL_TARGET = "models.stage1_dynamic.dqvae_dual_entropy.DualGrainVQModel"
TRIPLE_TARGET = "models.stage1_dynamic.dqvae_triple_feat.TripleGrainVQModel"
STD_REL = 0.10
MIN_ENTRIES = 1000
# tensors the JAX package draws with initializers of their own (not flax's defaults)
_OWN_INIT = ("lff.ffm.conv", "row_embed", "col_embed", "quantize.")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _entropy_config():
    cfg = dict(load_config([TINY])["model"]["params"])
    cfg["lossconfig"] = None
    return cfg


def _configs():
    from tests.test_torch_triple import dual_feat_config, triple_config

    return {
        "dual_entropy": (DUAL_TARGET, DualGrainVQModel, _entropy_config()),
        "dual_feat": (DUAL_TARGET, DualGrainVQModel, dual_feat_config()),
        "triple": (TRIPLE_TARGET, TripleGrainVQModel, triple_config()),
    }


@pytest.fixture(scope="module")
def inits():
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    out = {}
    for name, (target, cls, cfg) in _configs().items():
        jm = jinst({"target": target, "params": cfg})
        jvars = jax.jit(jm.init)(jax.random.PRNGKey(0))  # one compile, not op by op
        ref = {k: v.numpy() for k, v in dqvae_state_dict_from_flax(jax.device_get(jvars)).items()}
        port = cls(**cfg)
        port.init_weights(torch.Generator().manual_seed(0))
        out[name] = (ref, {k: v.numpy() for k, v in port.state_dict().items()})
    return out


def _kernels(sd):
    return [k for k, v in sd.items() if k.endswith(".weight") and v.ndim in (2, 4)
            and not any(s in k for s in _OWN_INIT)]


@pytest.mark.parametrize("name", ["dual_entropy", "dual_feat", "triple"])
def test_biases_zero_where_jax_is_zero(inits, name):
    ref, port = inits[name]
    zeros = [k for k, v in ref.items() if k.endswith(".bias") and not np.any(v)]
    assert len(zeros) > 10
    nonzero = [k for k in zeros if np.any(port[k])]
    assert not nonzero, nonzero


@pytest.mark.parametrize("name", ["dual_entropy", "dual_feat", "triple"])
def test_std_within_ten_percent_of_jax(inits, name):
    ref, port = inits[name]
    checked, off = 0, []
    for k, v in ref.items():
        if v.size < MIN_ENTRIES or not np.issubdtype(v.dtype, np.floating) or not v.std():
            continue
        checked += 1
        ratio = port[k].std() / v.std()
        if abs(ratio - 1.0) > STD_REL:
            off.append((k, float(ratio)))
    assert checked > 20
    assert not off, off


@pytest.mark.parametrize("name", ["dual_entropy", "dual_feat", "triple"])
def test_kernels_inside_the_truncation(inits, name):
    ref, port = inits[name]
    keys = _kernels(ref)
    assert sorted(keys) == sorted(_kernels(port)) and len(keys) > 20
    if name != "dual_entropy":  # the feature routers' gates are flax Dense layers
        assert any("router.gate" in k for k in keys)
    for k in keys:
        bound = 2.0 / math.sqrt(port[k][0].size) / _TRUNC_STD
        assert np.abs(port[k]).max() <= bound * (1 + 1e-6), k
        assert np.abs(ref[k]).max() <= bound * (1 + 1e-6), k


def test_lecun_normal_moments():
    w = torch.empty(512, 144)
    lecun_normal_(w, torch.Generator().manual_seed(1))
    assert abs(float(w.std()) * math.sqrt(144) - 1.0) < 0.01
    assert float(w.abs().max()) <= 2.0 / 12.0 / _TRUNC_STD


@pytest.fixture(scope="module")
def vgg_inits():
    """One JAX init of the LPIPS VGG16 backbone (flax `nn.Conv` defaults) and
    the port's seeded `LPIPS.init_weights`, as (kernel, bias) per conv, OIHW."""
    import jax

    from dynamicvectorquantization_torch.nn.lpips import LPIPS
    from dynamicvectorquantization_tpu.nn.lpips import VGG16Features

    jvars = jax.jit(VGG16Features().init)(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                                           np.float32))
    params = jax.device_get(jvars)["params"]
    ref = [(np.transpose(np.asarray(params[f"conv_{i}"]["kernel"]), (3, 2, 0, 1)),
            np.asarray(params[f"conv_{i}"]["bias"])) for i in range(len(params))]
    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(0))
    port = [(c.weight.numpy(), c.bias.numpy()) for c in lp.net.convs()]
    return ref, port


def test_lpips_backbone_moments_of_jax(vgg_inits):
    ref, port = vgg_inits
    assert len(ref) == len(port) == 13
    for i, ((rw, rb), (pw, pb)) in enumerate(zip(ref, port)):
        assert rw.shape == pw.shape, i
        assert not np.any(rb) and not np.any(pb), i
        ratio = pw.std() / rw.std()
        assert abs(ratio - 1.0) <= STD_REL, (i, float(ratio))


def test_lpips_backbone_inside_the_truncation(vgg_inits):
    ref, port = vgg_inits
    for i, ((rw, _), (pw, _)) in enumerate(zip(ref, port)):
        bound = 2.0 / math.sqrt(pw[0].size) / _TRUNC_STD
        assert np.abs(pw).max() <= bound * (1 + 1e-6), i
        assert np.abs(rw).max() <= bound * (1 + 1e-6), i
        # a plain normal of that variance would pass 2 sigma in ~4.6 % of entries
        assert np.abs(pw).max() > 0.9 * bound, i


def test_stage1_causes_reads_the_jax_runs_and_draws_a_second_backbone(tmp_path):
    """`tools/stage1_causes.py`: the figures it sets beside its legs, read
    from the committed r05 run, and the second backbone it hands to LPIPS
    through `DQVQ_LPIPS_VGG` is the seeded draw of that seed."""
    import json

    from dynamicvectorquantization_torch.nn.lpips import LPIPS
    from dynamicvectorquantization_torch.tools import stage1_causes

    with open(os.path.join(_REPO, "artifacts/campaign_r05/stage1_metrics.jsonl")) as f:
        out = stage1_causes.summarize([json.loads(line) for line in f])
    assert out["val_step"] == 384 and abs(out["val_rec_loss"] - 0.2051) < 1e-4
    assert abs(out["train_p_loss_steps_1_40"] - 0.1469) < 1e-4
    path = str(tmp_path / "vgg16.pt")
    stage1_causes.write_vgg16(path, seed=2)
    drawn, read = LPIPS(), LPIPS()
    drawn.init_weights(torch.Generator().manual_seed(2))
    read.load_weights(path)
    for a, b in zip(drawn.net.convs(), read.net.convs()):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)


def test_stage1_causes_compares_a_run_with_the_jax_runs_row_by_row():
    """`stage1_causes --compare`: the JAX run r05 held to r04 / r05 lies
    inside the band at every row (its own value is an end of the band); a
    copy with one row moved outside is found at that row, and the window
    means are the rows' means."""
    import json

    from dynamicvectorquantization_torch.tools import stage1_causes

    runs = []
    for name in stage1_causes.JAX_RUNS:
        with open(os.path.join(_REPO, "artifacts", name, "stage1_metrics.jsonl")) as f:
            runs.append([json.loads(line) for line in f])
    same = stage1_causes.compare(runs[1], runs)
    assert all(v["first_outside"] is None and v["n_outside"] == 0 for v in same.values())
    rows = [dict(r) for r in runs[1]]
    moved = next(r for r in rows if r["split"] == "train" and r["step"] == 132)
    moved["train_rec_loss"] = 10.0
    got = stage1_causes.compare(rows, runs)["train_rec_loss"]
    assert got["first_outside"][0] == 132 and got["n_outside"] == 1
    train = [r for r in runs[1] if r["split"] == "train" and r["step"] <= 40]
    mean = sum(r["train_rec_loss"] for r in train) / len(train)
    assert abs(same["train_rec_loss"]["windows"][40][0] - mean) < 1e-12
