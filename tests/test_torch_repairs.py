"""Loading what the port's own trainers write, and the LPIPS weights from
files, at the tiny smoke configs on the CPU:

- a stage-2 checkpoint of the training command line (`step_<n>.pt`, its
  `checkpoints/` directory, or the run's logdir) serves: greedy tokens of the
  loaded model equal those of the trainer's model in memory;
- a first-stage `ckpt_path` that names a stage-1 run's `checkpoints/`
  directory loads its weights outside the loop too, and one that exists but
  cannot be read raises instead of leaving seeded weights;
- the LPIPS VGG16 backbone and lin heads load from a torchvision `vgg16`
  state dict and a lin-head file, given as arguments or through
  `DQVQ_LPIPS_VGG` / `DQVQ_LPIPS_LIN`.
"""
import os

import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import dump_yaml, load_config
from dynamicvectorquantization_torch.nn.lpips import LPIPS, TAP_CHANNELS, VGG16_CFG
from dynamicvectorquantization_torch.train import cli
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE2 = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
STAGE1 = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
COMMON = ["--device", "cpu", "--max_epochs", "1", "--max_steps_per_epoch", "2", "--save_n", "1",
          "--image_log_every", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _only_run(root):
    (name,) = os.listdir(root)
    return os.path.join(root, name)


def _greedy(model, n=3):
    return model.sample_from_scratch(*model.encode_to_c(n, "cpu"), sample=False)


@pytest.fixture(scope="module")
def stage2_run(tmp_path_factory):
    """Two optimizer steps of the tiny stage-2 config through the command
    line: (the trainer in memory, the run's logdir)."""
    root = str(tmp_path_factory.mktemp("s2"))
    trainer = cli.main(["--base", STAGE2, "--logdir", root, *COMMON])
    assert trainer.count == 2
    return trainer, _only_run(root)


def test_a_cli_checkpoint_serves_as_file_directory_and_logdir(stage2_run):
    trainer, run = stage2_run
    trainer.model.eval()
    want = _greedy(trainer.model)
    ckpt_dir = os.path.join(run, "checkpoints")
    (name,) = [n for n in os.listdir(ckpt_dir) if n.endswith(".pt")]
    for path in (os.path.join(ckpt_dir, name), ckpt_dir, run):
        model, sd = load_model_and_variables(STAGE2, model_path=path, device="cpu")
        for key, master in trainer.masters.items():
            assert torch.equal(sd[f"transformer.{key}"], master), (path, key)
        for key, v in trainer.model.first_stage_model.state_dict().items():
            assert torch.equal(sd[f"first_stage_model.{key}"], v), (path, key)
        got = _greedy(model)
        for a, b in zip(got, want):
            assert torch.equal(a, b), path
    # a trained model, not the seeded one: the greedy tokens differ
    fresh, _ = load_model_and_variables(STAGE2, seed=0, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(_greedy(fresh), want))


def _stage2_yaml(tmp_path, ckpt_path):
    cfg = load_config([STAGE2])
    cfg["model"]["params"]["first_stage_config"]["params"]["ckpt_path"] = ckpt_path
    path = tmp_path / f"stage2-{len(os.listdir(tmp_path))}.yml"
    path.write_text(dump_yaml(cfg) + "\n")
    return str(path)


def test_first_stage_ckpt_path_directory_loads_and_an_unreadable_one_raises(tmp_path):
    s1 = cli.main(["--base", STAGE1, "--logdir", str(tmp_path / "s1"), *COMMON])
    ckpts = os.path.join(_only_run(str(tmp_path / "s1")), "checkpoints")
    model, _ = load_model_and_variables(_stage2_yaml(tmp_path, ckpts), seed=0, device="cpu")
    want = s1.model.state_dict()
    got = model.first_stage_model.state_dict()
    assert len(got) > 50
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # the shipped configs' placeholder path does not exist: seeded weights, as the JAX package
    seeded, _ = load_model_and_variables(_stage2_yaml(tmp_path, str(tmp_path / "absent")),
                                         seed=0, device="cpu")
    assert not torch.equal(seeded.first_stage_model.state_dict()["encoder.conv_in.weight"],
                           want["encoder.conv_in.weight"])
    broken = tmp_path / "broken.ckpt"
    broken.write_bytes(b"not a checkpoint")
    empty = tmp_path / "empty"
    empty.mkdir()
    for bad in (str(broken), str(empty)):
        with pytest.raises(Exception):
            load_model_and_variables(_stage2_yaml(tmp_path, bad), seed=0, device="cpu")


def _vgg16_state_dict(generator):
    """A torchvision `vgg16().state_dict()` in layout (features.{i}, a
    classifier), filled from a seeded generator."""
    sd, index, in_ch = {}, 0, 3
    for v in VGG16_CFG:
        if v == "M":
            index += 1
            continue
        sd[f"features.{index}.weight"] = torch.randn((v, in_ch, 3, 3), generator=generator)
        sd[f"features.{index}.bias"] = torch.randn((v,), generator=generator)
        in_ch, index = v, index + 2
    sd["classifier.0.weight"] = torch.randn((16, 8), generator=generator)
    return sd


def _check_lpips(net, vgg, lin):
    convs = {f"features.{idx}": mod for sl in net.net.children()
             for idx, mod in sl.named_children() if isinstance(mod, torch.nn.Conv2d)}
    assert len(convs) == 13
    for name, conv in convs.items():
        assert torch.equal(conv.weight, vgg[f"{name}.weight"]), name
        assert torch.equal(conv.bias, vgg[f"{name}.bias"]), name
    for key, w in lin.items():
        assert torch.equal(net.state_dict()[key], w), key


def test_lpips_weights_from_files_and_the_environment(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(3)
    vgg = _vgg16_state_dict(g)
    lin = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
           for i, c in enumerate(TAP_CHANNELS)}
    vgg_path, lin_path = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg_lin.pth")
    torch.save(vgg, vgg_path)
    torch.save(lin, lin_path)

    net = LPIPS()
    net.init_weights(torch.Generator().manual_seed(0), vgg_path=vgg_path, lin_path=lin_path)
    _check_lpips(net, vgg, lin)
    with pytest.raises(KeyError, match="vgg16"):
        LPIPS().load_weights(vgg_path=lin_path)

    monkeypatch.setenv("DQVQ_LPIPS_VGG", vgg_path)
    monkeypatch.setenv("DQVQ_LPIPS_LIN", lin_path)
    model = instantiate_from_config(load_config([STAGE1])["model"])
    trainer = Stage1Trainer(model, 1e-4, device="cpu")
    trainer.init_state(torch.Generator().manual_seed(0))
    _check_lpips(model.loss.perceptual_loss, vgg, lin)
    # the arguments take precedence over the environment
    other = {k: v + 1 for k, v in vgg.items()}
    torch.save(other, tmp_path / "other.pth")
    trainer.init_state(torch.Generator().manual_seed(0), lpips_vgg_path=str(tmp_path / "other.pth"))
    _check_lpips(model.loss.perceptual_loss, other, lin)
