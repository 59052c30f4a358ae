"""A run with its timed path broken underneath reads `correct` false:
the harness's look for a card is skipped, the rest of the run is driven
at a CPU test's size, once for each fault the cell can have. (The cells
run on one card: none has an exchange between cards to leave out.)"""
import numpy as np
import pytest
import torch

from conftest import run_tiny
from common import is_correct

from wsi_hgnn_tpu_torch import serve
from wsi_hgnn_tpu_torch.train import trainer as trainer_mod


def alter_answers(monkeypatch):
    """Every probability the predictor produces moved by 0.01."""
    real = serve.SlidePredictor.predict_many

    def altered(self, slides):
        p = real(self, slides)
        return np.clip(p + np.array([0.01, -0.01], np.float32), 0, 1)

    monkeypatch.setattr(serve.SlidePredictor, "predict_many", altered)


def test_clean_runs_are_correct():
    for cell in ("heat4-serve-features", "hgt-train"):
        assert is_correct(run_tiny(cell).checks), cell


@pytest.mark.parametrize("cell", ["heat4-serve-pixels", "heat4-serve-features"])
def test_an_altered_answer_fails(cell, monkeypatch):
    alter_answers(monkeypatch)
    assert not is_correct(run_tiny(cell, seconds=0.5).checks)


def test_misaligned_features_fail(monkeypatch):
    """Each patch served its neighbour's features."""
    real = serve.SlidePredictor.featurize

    def altered(self, px):
        f, t = real(self, px)
        return np.roll(f, 1, axis=0), t

    monkeypatch.setattr(serve.SlidePredictor, "featurize", altered)
    out = run_tiny("heat4-serve-pixels", seconds=0.5)
    assert out.checks["feat_rel_l2"][0] > out.checks["feat_rel_l2"][1]


@pytest.mark.parametrize("cell", ["hgt-train", "heat4-train"])
def test_a_step_that_leaves_its_state_unchanged_fails(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not is_correct(run_tiny(cell).checks)


def test_half_the_batch_left_out_fails(monkeypatch):
    real = trainer_mod.parse_loss

    def half(cfg):
        loss = real(cfg)

        def first_half(logits, labels, weights):
            k = max(1, logits.shape[0] // 2)
            return loss(logits[:k], labels[:k], weights[:k])
        return first_half

    monkeypatch.setattr(trainer_mod, "parse_loss", half)
    assert not is_correct(run_tiny("heat4-train").checks)
