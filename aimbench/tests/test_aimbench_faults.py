"""A run with its timed path broken underneath comes out not correct: the
rest of a run (``run.measure`` at the tiny size on the CPU, the chip's
look skipped) over a train step that leaves its state unchanged, one whose
loss is the mean over half of the batch, one whose learning rate is 1.1
times the schedule's, an eval step that alters an answer where it is
produced, one that leaves half of the videos out and one that leaves a
view out of the average. The limits are a sound tiny run's readings times
four; the sound run passes them on another seed."""

import time

import pytest
import torch

from tiny_cells import tiny
from aimbench import run

TRAIN, EVAL = "aim-b16-8f.train-b32", "aim-b16-8f.eval3v-b32"


def _measure(workload, limits, seed=2 ** 33 + 1):
    cell = tiny(workload, clips=4, limits=limits)
    result, _ = run.measure(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter())
    return result


@pytest.fixture(scope="module")
def limits():
    out = {}
    for w in (TRAIN, EVAL):
        shown = _measure(w, {}, seed=12)["compared"]
        out[w] = {k: 4 * v["value"] for k, v in shown.items()}
        assert _measure(w, out[w])["correct"] is True
    return out


def test_state_left_unchanged(limits, monkeypatch):
    from adapt_image_models_torch.core import optim
    monkeypatch.setattr(optim.Optimizer, "update", lambda self, grads: True)
    result = _measure(TRAIN, limits[TRAIN])
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_learning_rate_off_by_a_tenth(limits, monkeypatch):
    from adapt_image_models_torch.core import optim
    real = optim.Optimizer.lr
    monkeypatch.setattr(optim.Optimizer, "lr", lambda self: 1.1 * real(self))
    result = _measure(TRAIN, limits[TRAIN])
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(0.1, abs=0.02)


def test_half_of_the_batch_left_out(limits, monkeypatch):
    from adapt_image_models_torch.core import train_state
    real = train_state.cross_entropy
    monkeypatch.setattr(train_state, "cross_entropy",
                        lambda logits, labels: real(logits[: len(logits) // 2],
                                                    labels[: len(labels) // 2]))
    assert _measure(TRAIN, limits[TRAIN])["correct"] is False


def _patch_average(monkeypatch, change):
    from adapt_image_models_torch.apis import test as port_test
    real = port_test.average_clip
    monkeypatch.setattr(port_test, "average_clip", lambda *a, **k: change(real(*a, **k)))


def test_an_answer_altered(limits, monkeypatch):
    def alter(scores):
        scores = scores.clone()
        scores[0] = torch.roll(scores[0], 1)
        return scores
    _patch_average(monkeypatch, alter)
    assert _measure(EVAL, limits[EVAL])["correct"] is False


def test_half_of_the_videos_left_out(limits, monkeypatch):
    _patch_average(monkeypatch, lambda scores: scores[: len(scores) // 2])
    result = _measure(EVAL, limits[EVAL])
    assert result["correct"] is False
    assert result["compared"]["prob_l1"]["value"] == float("inf")


def test_a_view_left_out(limits, monkeypatch):
    from adapt_image_models_torch.apis import test as port_test
    real = port_test.average_clip

    def first_views(logits, views, *a, **k):
        kept = logits.reshape(-1, views, logits.shape[-1])[:, :views - 1]
        return real(kept.reshape(-1, logits.shape[-1]), views - 1, *a, **k)
    monkeypatch.setattr(port_test, "average_clip", first_views)
    assert _measure(EVAL, limits[EVAL])["correct"] is False
