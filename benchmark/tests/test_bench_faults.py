"""A run of each cell on the CPU, skipping only the harness's look for a
card, with the timed path broken underneath: `correct` comes out false for
each fault a cell can have (an answer altered where it is produced; a step
that leaves the state unchanged; half of each batch left out, the mean
taken over the rest), and true without a fault. Also: without a card a
run fails with no result line, and a weights file with another sha256 is
refused."""

import copy
import json
import os

import pytest

from benchmark import calibrate
from benchmark.harness import main

from conftest import ROOT, SEED, run_harness


@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views", "zju-train-1024"])
def test_sound_run_is_correct(cell):
    rc, line, err = run_harness(cell)
    assert rc == 0, err
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views"])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from gpnerf_tpu_torch.render import demo

    orig = demo.Renderer.render_demo

    def altered(self, batch):
        ret = orig(self, batch)
        ret["pred_chw"] = ret["pred_chw"] * 0.9
        return ret

    monkeypatch.setattr(demo.Renderer, "render_demo", altered)
    rc, line, _ = run_harness(cell)
    assert rc == 0 and line["correct"] is False
    assert line["check"]["image_rmse"]["value"] > line["check"]["image_rmse"]["limit"]


def test_unchanged_state_is_not_correct(monkeypatch):
    from gpnerf_tpu_torch.train import step

    def no_update(render, criterion, optimizer, scheduler, batch, generator=None, t_rand=None):
        return step.forward_backward(render, criterion, optimizer, batch, generator, t_rand)

    monkeypatch.setattr(step, "train_step", no_update)
    rc, line, _ = run_harness("zju-train-1024")
    assert rc == 0 and line["correct"] is False
    # no leaf of the program moves: every leaf's change reads 1
    assert line["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    with calibrate.half_batch():
        rc, line, _ = run_harness("zju-train-1024")
    assert rc == 0 and line["correct"] is False
    assert line["check"]["loss_gap"]["value"] > line["check"]["loss_gap"]["limit"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main(["--workload", "zju-fast-views", "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_weights_with_another_hash_are_refused():
    from benchmark.reference.build import check_weights

    conf = copy.deepcopy(json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                                     "gpnerf-zju-fast.json"))))
    conf["weights"]["sha256"] = "0" * 64
    with pytest.raises(SystemExit, match="sha256"):
        check_weights(conf["weights"])
