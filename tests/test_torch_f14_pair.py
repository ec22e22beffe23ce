"""The comparison of F14's CPU leg (`tools/stage1_causes.py` `cpu_pair`):
the port's run and the JAX package's (`tests/fixtures/stage1/jax_cpu_pair.py`)
read from their `metrics.jsonl` files, the step-by-step gaps, and the
decision rule (the first four steps within the one-step parity tolerances,
then the port's gap within 10x the one-ulp control's), on logs written
here; and the reference's f32 reduction that the rule's first steps allow
for. The codebook restart draw both runs take is the same numpy draw for a
step, whoever asks."""
import json

import numpy as np
import torch

from dynamicvectorquantization_torch.tools import stage1_causes as sc


def _rows(values, scale=1.0, val=None):
    rows = [{"step": s, "split": "train", **{k: v * scale for k in sc.COMPARED}}
            for s, v in enumerate(values, start=1)]
    if val is not None:
        rows.append({"step": len(values), "split": "val", "val_rec_loss": val})
    return rows


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def test_pair_reads_both_logs_and_measures_gaps(tmp_path):
    ref = _rows([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], val=0.2)
    port = _rows([1.0, 0.9, 0.8, 0.7, 0.66, 0.5], val=0.21)
    a = sc._read_rows(_write(tmp_path / "port.jsonl", port))
    b = sc._read_rows(_write(tmp_path / "jax.jsonl", ref))
    gaps = sc.pair_gaps(a, b)
    assert sorted(gaps) == [1, 2, 3, 4, 5, 6]
    assert gaps[1] == 0.0 and abs(gaps[5] - 0.1) < 1e-12
    assert sc.summarize(a)["val_rec_loss"] == 0.21 and sc.summarize(b)["val_step"] == 6


def test_pair_decision_rule():
    assert "train_quant_loss" not in sc.PAIR_KEYS and len(sc.PAIR_KEYS) == len(sc.COMPARED) - 1
    ref = _rows([1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4])
    control = _rows([1.0, 0.9, 0.8, 0.7, 0.6 * (1 + 1e-3), 0.5 * (1 + 2e-3), 0.4 * (1 + 4e-3)])
    inside = _rows([1.0, 0.9, 0.8, 0.7, 0.6 * (1 + 5e-3), 0.5 * (1 + 1e-2), 0.4 * (1 + 3e-2)])
    d = sc.pair_decision(inside, ref, control)
    assert d == {"early_ok": True, "first_outside": None, "verdict": "draw difference"}
    outside = _rows([1.0, 0.9, 0.8, 0.7, 0.6 * (1 + 5e-2), 0.5, 0.4])
    assert sc.pair_decision(outside, ref, control)["first_outside"] == 5
    early = _rows([1.0, 0.9 * (1 + 1e-3), 0.8, 0.7, 0.6, 0.5, 0.4])
    d = sc.pair_decision(early, ref, control)
    assert not d["early_ok"] and d["verdict"] == "fault located"


def test_pair_report_from_the_command_line(tmp_path, capsys):
    ref = _rows([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], val=0.2)
    control = _rows([1.0, 0.9, 0.8, 0.7, 0.6 * (1 + 1e-3), 0.5 * (1 + 1e-3)], val=0.21)
    port = _rows([1.0, 0.9, 0.8, 0.7, 0.6 * (1 + 2e-3), 0.5], val=0.19)
    for name, rows in (("jax", ref), ("control", control)):
        (tmp_path / name).mkdir()
        _write(tmp_path / name / "metrics.jsonl", rows)
    assert sc.main(["--pair_compare", str(_write(tmp_path / "port.jsonl", port)),
                    "--pair", str(tmp_path / "jax"), "--pair_control",
                    str(tmp_path / "control")]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["decision"]["verdict"] == "draw difference"
    assert report["worst_running_ratio_after_step_4"][0] == 5
    assert abs(report["gaps"]["5"]["running_ratio"] - 2.0) < 1e-9
    assert report["val"]["port"]["val_rec_loss"] == 0.19


def test_restart_draw_is_a_function_of_the_step():
    n1, p1 = sc.restart_draw(7, 100, (100, 4))
    n2, p2 = sc.restart_draw(7, 100, (100, 4))
    assert np.array_equal(p1, p2) and np.array_equal(n1, n2)
    assert sorted(p1.tolist()) == list(range(100)) and n1.dtype == np.float32
    assert not np.array_equal(sc.restart_draw(8, 100)[1], p1)
    assert sc.restart_draw(8, 100)[0] is None


def test_xla_cpu_f32_mean_of_the_commitment_term_strays_from_f64():
    """Why the decision reads every log but `train_quant_loss`: XLA's CPU f32
    mean over a 4-D tensor of the commitment term's shape and statistics
    ((8, 16, 16, 256) and (8, 32, 32, 256), squared N(0, s^2) values, 31 %
    of the positions masked) strays from the f64 mean by more than the
    parity tolerance's 1e-5 at the larger shape; torch's f32 mean stays
    within 1e-6."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    worst = {}
    for shape in ((8, 16, 16, 256), (8, 32, 32, 256)):
        x = (rng.standard_normal(shape).astype(np.float32) * 0.7) ** 2
        x = x * (rng.random(shape[:-1] + (1,)) < 0.69).astype(np.float32)
        ref = x.astype(np.float64).mean()
        worst[shape] = abs(float(jnp.mean(jnp.asarray(x))) - ref) / ref
        assert abs(float(torch.from_numpy(x).mean()) - ref) / ref < 1e-6
    assert worst[(8, 32, 32, 256)] > 1e-5
