"""The port's single-device training runtime on its own, at the tiny smoke
configs on the CPU: the command line (`python -m
dynamicvectorquantization_torch.train`: config merge, dotlist overrides,
snapshot round trip, LR rule, refusals of what is not ported), resume equal
to an uninterrupted run to the bit with all three dropouts at 0.1,
checkpoint retention (top-k by the monitored metric plus the newest, atomic
writes), the preemption guard, `eval_only`, and the stage-1 -> stage-2
checkpoint handoff.
"""
import json
import os
import signal

import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import (
    apply_dotlist,
    dump_yaml,
    load_config,
    parse_yaml,
)
from dynamicvectorquantization_torch.train import cli
from dynamicvectorquantization_torch.train.loop import PreemptionGuard, Trainer
from dynamicvectorquantization_torch.utils.checkpoint import CheckpointManager
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE2 = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
STAGE1 = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
DROPOUTS = [f"model.params.transformer_config.params.{k}=0.1"
            for k in ("attn_pdrop", "resid_pdrop", "embd_pdrop")]
COMMON = ["--device", "cpu", "--max_steps_per_epoch", "3", "--log_every", "1", "--save_n", "1",
          "--image_log_every", "0"]


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _only_run(root):
    (name,) = os.listdir(root)
    return os.path.join(root, name)


def _hash(trainer):
    return {k: v.double().sum().item() for k, v in trainer.masters.items()}


@pytest.fixture(scope="module")
def whole_run(tmp_path_factory):
    """Two epochs of the tiny stage-2 config in one run, dropouts at 0.1."""
    root = str(tmp_path_factory.mktemp("whole"))
    step_obj = cli.main(["--base", STAGE2, "--logdir", root, "--max_epochs", "2", *COMMON,
                         *DROPOUTS])
    return step_obj, _only_run(root)


def test_cli_run_leaves_rows_checkpoint_and_snapshot(whole_run):
    step_obj, logdir = whole_run
    rows = _rows(logdir)
    assert [(r["step"], r["split"]) for r in rows] == [
        (1, "train"), (2, "train"), (3, "train"), (3, "val"),
        (4, "train"), (5, "train"), (6, "train"), (6, "val")]
    assert all(torch.isfinite(torch.tensor(r.get("train_loss", r.get("val_loss")))) for r in rows)
    assert rows[0]["lr"] > rows[5]["lr"] > 0 and "cache_encode_seconds" in rows[0]
    assert os.path.basename(logdir).startswith("dqtransformer-uncond-tiny-")
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints"))) == ["index.json", "step_6.pt"]
    snap = load_config([os.path.join(logdir, "configs", "merged-project.yaml")])
    want = load_config([STAGE2], DROPOUTS)
    assert snap == want and snap["model"]["params"]["transformer_config"]["params"][
        "attn_pdrop"] == 0.1
    with open(os.path.join(logdir, "argv.json")) as f:
        assert "--base" in json.load(f)
    assert step_obj.count == 6 and step_obj.epoch == 2


def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(whole_run, tmp_path):
    whole, whole_dir = whole_run
    root = str(tmp_path)
    first = cli.main(["--base", STAGE2, "--logdir", root, "--max_epochs", "2", "--stop_epoch", "1",
                      *COMMON, *DROPOUTS])
    assert first.count == 3 and first.epoch == 1
    logdir = _only_run(root)
    resumed = cli.main(["--resume", logdir, "--max_epochs", "2", *COMMON])
    assert resumed is not first and resumed.count == 6 and resumed.epoch == 2
    assert _hash(resumed) == _hash(whole)
    for name in whole.masters:
        assert torch.equal(whole.masters[name], resumed.masters[name]), name
        assert torch.equal(whole.v[name], resumed.v[name]), name
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k not in ("time", "images_per_sec", "cache_encode_seconds")}
    assert [strip(r) for r in _rows(logdir)] == [strip(r) for r in _rows(whole_dir)]
    # a run that is over resumes to nothing more
    again = cli.main(["--resume", logdir, "--max_epochs", "2", *COMMON])
    assert again.count == 6 and len(_rows(logdir)) == 8


def test_dropout_masks_differ_between_runs_with_other_seeds(whole_run, tmp_path):
    other = cli.main(["--base", STAGE2, "--logdir", str(tmp_path), "--max_epochs", "2",
                      "--seed", "24", *COMMON, *DROPOUTS])
    assert _hash(other) != _hash(whole_run[0])


def test_eval_only_validates_the_resumed_state(whole_run):
    _, logdir = whole_run
    before = _rows(logdir)
    cli.main(["--resume", logdir, "-t", "False", *COMMON])
    rows = _rows(logdir)
    assert len(rows) == len(before) + 1 and rows[-1]["split"] == "val" and rows[-1]["step"] == 6
    assert rows[-1]["val_loss"] == before[-1]["val_loss"]


def test_learning_rate_rule(capsys):
    class Model:
        pass

    m = Model()
    cfg = {"model": {"base_learning_rate": 4.5e-6}, "data": {"params": {"batch_size": 30}}}
    cli.set_learning_rate(m, cfg, accumulate_grad_batches=2)
    assert m.learning_rate == 2 * 1 * 30 * 4.5e-6 and m.min_learning_rate == 0.0
    assert "Setting learning rate to 2.70e-04" in capsys.readouterr().out
    cfg = {"model": {"learning_rate": 5e-4, "min_learning_rate": 1e-5},
           "data": {"params": {"batch_size": 30}}}
    cli.set_learning_rate(m, cfg, 4)
    assert (m.learning_rate, m.min_learning_rate) == (5e-4, 1e-5)
    with pytest.raises(SystemExit):
        cli.set_learning_rate(m, {"model": {}, "data": {"params": {"batch_size": 1}}}, 1)


def test_parser_keeps_the_reference_flags():
    opt, unknown = cli.get_parser().parse_known_args(
        ["--base", "a.yml", "b.yml", "-t", "True", "--gpus", "1", "--save_n", "2",
         "--accumulate_grad_batches", "3", "--cached_codes", "off", "data.params.batch_size=4"])
    assert opt.base == ["a.yml", "b.yml"] and opt.devices == 1 and opt.save_n == 2
    assert opt.accumulate_grad_batches == 3 and opt.cached_codes == "off"
    assert (opt.seed, opt.max_epochs, opt.log_every, opt.image_log_every) == (23, 50, 50, 50)
    assert unknown == ["data.params.batch_size=4"]


def test_dotlist_overrides_and_yaml_round_trip():
    base = {"model": {"params": {"n": 1, "name": "x"}}, "data": {"target": "t"}}
    out = apply_dotlist(base, ["model.params.n=3", "model.params.rate=1.0e-05",
                               "model.extra.deep.flag=true", "data.target=other",
                               "model.params.name=null"])
    assert out["model"]["params"] == {"n": 3, "name": None, "rate": 1e-5}
    assert out["model"]["extra"] == {"deep": {"flag": True}} and out["data"]["target"] == "other"
    assert base["model"]["params"]["n"] == 1
    with pytest.raises(ValueError):
        apply_dotlist(base, ["no-equals-sign"])
    cfg = {"a": {"lr": 1e-5, "big": 2.5e16, "list": [1, 2.5, "s", True], "none": None,
                 "text": "put your # path: here", "quoted": 'say "hi"', "int": -3, "neg": -0.5,
                 "looks_like_int": "12", "looks_like_bool": "true", 7: "int key"},
           "empty_list": []}
    assert parse_yaml(dump_yaml(cfg)) == cfg
    for path in (STAGE1, STAGE2, os.path.join(_REPO, "configs/stage2/uncond_imagenet_p6c18.yml"),
                 os.path.join(_REPO, "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml")):
        loaded = load_config([path])
        assert parse_yaml(dump_yaml(loaded)) == loaded, path
    for bad in ({"x": float("inf")}, {"x": "both ' and \""}, {"x": ["a,b"]}, {"x": object()}):
        with pytest.raises(ValueError):
            dump_yaml(bad)


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], "Multi-GPU"), (["--sp", "2"], "Multi-GPU"), (["--pp", "2"], "Multi-GPU"),
    (["--activate_ddp_share"], "Multi-GPU"), (["--activate_fsdp"], "Multi-GPU"),
    (["--devices", "4"], "Multi-GPU"), (["--steps_per_dispatch", "8"], "CUDA graph"),
])
def test_unported_flags_raise_and_name_their_roadmap_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        cli.main(["--base", STAGE2, "--logdir", str(tmp_path), *COMMON, *flags])
    assert item in str(err.value)
    with open(os.path.join(_REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    quoted = str(err.value).split("'")[1]
    assert quoted in roadmap, quoted


def test_cli_needs_a_card_or_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cpu"):
        cli.main(["--base", STAGE2, "--logdir", str(tmp_path), "--max_epochs", "1"])
    with pytest.raises(NotImplementedError):
        cli.main(["--base", STAGE2, "--logdir", str(tmp_path), "--logtype", "wandb", *COMMON])


def _save(mngr, step, val):
    return mngr.save(step, {"step": step, "w": torch.full((3,), float(step))}, {"val_loss": val})


def test_checkpoints_keep_the_best_k_and_the_newest(tmp_path):
    mngr = CheckpointManager(str(tmp_path), save_top_k=2, monitor="val_loss")
    assert mngr.latest() is None
    with pytest.raises(FileNotFoundError):
        mngr.restore()
    for step, val in ((10, 3.0), (20, 1.0), (30, 2.0), (40, 5.0)):
        _save(mngr, step, val)
    assert mngr.all_steps() == [20, 30, 40]  # best two (20, 30) and the newest (40)
    _save(mngr, 50, 0.5)
    assert mngr.all_steps() == [20, 50]  # the newest is among the best: two files
    _save(mngr, 60, 9.0)
    assert mngr.all_steps() == [20, 50, 60] and mngr.latest() == 60
    assert float(mngr.restore()["w"][0]) == 60.0 and mngr.restore(20)["step"] == 20
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # a new manager on the same directory remembers the metrics
    again = CheckpointManager(str(tmp_path), save_top_k=2, monitor="val_loss")
    assert again.metrics[20] == {"val_loss": 1.0}
    _save(again, 70, 0.7)
    assert again.all_steps() == [50, 70]
    # save_top_k 1: newest + best, at most two files
    one = CheckpointManager(str(tmp_path / "one"), save_top_k=1, monitor="val_loss")
    for step, val in ((1, 1.0), (2, 2.0), (3, 3.0)):
        _save(one, step, val)
    assert one.all_steps() == [1, 3]
    # no monitor: the newest k
    plain = CheckpointManager(str(tmp_path / "plain"), save_top_k=2)
    for step in (1, 2, 3):
        _save(plain, step, 0.0)
    assert plain.all_steps() == [2, 3]


def test_a_failed_write_leaves_the_older_checkpoint_whole(tmp_path, monkeypatch):
    mngr = CheckpointManager(str(tmp_path), save_top_k=1, monitor="val_loss")
    _save(mngr, 1, 1.0)

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        _save(mngr, 2, 0.5)
    monkeypatch.undo()
    assert mngr.all_steps() == [1] and mngr.restore()["step"] == 1


def test_preemption_guard_records_signals_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.should_stop and guard.reason is None
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.should_stop and guard.reason == "SIGUSR1"
    assert signal.getsignal(signal.SIGTERM) is before


def test_sigterm_saves_an_emergency_checkpoint_and_stops(tmp_path, capsys):
    """SIGTERM during step 2 of 8: the step finishes, the state is saved at
    that step, the loop returns; a resume then trains on to the end."""
    cfg = load_config([STAGE2])

    def build():
        model = instantiate_from_config(cfg["model"])
        model.learning_rate = 1e-3
        return model, instantiate_from_config(cfg["data"])

    def trainer():
        return Trainer(str(tmp_path), max_epochs=1, seed=1, log_every=1, image_log_frequency=0,
                       save_top_k=1, device="cpu")

    model, data = build()
    loop = trainer()
    real_fit = loop._run_epochs

    def fit_with_signal(step_obj, *args):
        args = list(args)
        step_fn = args[4]

        def stepping(x):
            if step_obj.count == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(x)

        args[4] = stepping
        return real_fit(step_obj, *args)

    loop._run_epochs = fit_with_signal
    stopped = loop.fit(model, data)
    assert stopped.count == 2 and stopped.epoch == 0
    assert "[preempt:SIGTERM] emergency checkpoint saved at step 2" in capsys.readouterr().out
    assert os.listdir(tmp_path / "checkpoints") and not os.path.exists(
        tmp_path / "loop_buckets.json")
    assert [r["step"] for r in _rows(str(tmp_path))] == [1]  # the row of step 2 never came
    model, data = build()
    resumed = trainer().fit(model, data)
    assert resumed.epoch == 1 and resumed.count == 2 + 8
    assert "Resumed from checkpoint step 2" in capsys.readouterr().out


def test_stage1_checkpoint_feeds_the_stage2_first_stage(tmp_path):
    s1 = cli.main(["--base", STAGE1, "--logdir", str(tmp_path / "s1"), "--max_epochs", "1",
                   "--device", "cpu", "--max_steps_per_epoch", "1", "--image_log_every", "0"])
    ckpts = os.path.join(_only_run(str(tmp_path / "s1")), "checkpoints")
    s2 = cli.main(["--base", STAGE2, "--logdir", str(tmp_path / "s2"), "--max_epochs", "1",
                   *COMMON, f"model.params.first_stage_config.params.ckpt_path={ckpts}"])
    want = s1.model.state_dict()
    got = s2.model.first_stage_model.state_dict()
    assert len(got) > 50
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # without a checkpoint the first stage is seeded from --seed
    s3 = cli.main(["--base", STAGE2, "--logdir", str(tmp_path / "s3"), "--max_epochs", "1",
                   *COMMON])
    assert not torch.equal(s3.model.first_stage_model.state_dict()["encoder.conv_in.weight"],
                           want["encoder.conv_in.weight"])


@pytest.mark.cuda
def test_cuda_cli_trains_with_dropout_and_resumes_bit_equal(tmp_path):
    """The tiny stage-2 config on the card, bf16 over f32 masters, all three
    dropouts 0.1: the attention kernels draw masks, and a resumed run ends
    where the uninterrupted one ends."""
    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward,
        fused_attention_forward,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    extra = ["model.params.compute_dtype=bfloat16", *DROPOUTS]
    common = [a if a != "cpu" else "cuda" for a in COMMON]
    before = fused_attention_forward.dropout_launches, fused_attention_backward.dropout_launches
    whole = cli.main(["--base", STAGE2, "--logdir", str(tmp_path / "a"), "--max_epochs", "2",
                      *common, *extra])
    layers, steps = 4, 6
    assert fused_attention_forward.dropout_launches - before[0] == layers * steps
    assert fused_attention_backward.dropout_launches - before[1] == layers * steps
    cli.main(["--base", STAGE2, "--logdir", str(tmp_path / "b"), "--max_epochs", "2",
              "--stop_epoch", "1", *common, *extra])
    resumed = cli.main(["--resume", _only_run(str(tmp_path / "b")), "--max_epochs", "2", *common])
    for name in whole.masters:
        assert torch.equal(whole.masters[name], resumed.masters[name]), name
