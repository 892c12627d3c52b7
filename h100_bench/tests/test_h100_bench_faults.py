"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
(``run.execute``) at a tiny size on the CPU, with one fault planted in the
port: an answer altered where it is produced (sampler and serve cells), a
train step that leaves its state unchanged, and half of each microbatch
left out of the loss (training cell). The cells run on one chip, so there
is no exchange between chips to leave out. The sound run beside them
comes out correct.
"""
import pytest
import torch

from h100_bench import run
from h100_bench.tests import tiny

BENCH = run.benchmark()


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def altered_answers(monkeypatch):
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor

    orig = LatentDiffusionPredictor._decode_and_finish

    def broken(self, x, img):
        out = orig(self, x, img)
        out[0] = 1.5 * out[0]
        return out

    monkeypatch.setattr(LatentDiffusionPredictor, "_decode_and_finish", broken)


def unchanged_state(monkeypatch):
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as t

    monkeypatch.setattr(t.AccumAdam, "accumulate", lambda self, grads, keep, accum: None)
    monkeypatch.setattr(t.AccumAdam, "apply", lambda self: None)


def half_batch(monkeypatch):
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as t

    orig = t.make_loss_fn

    def make(vae, name):
        losses = orig(vae, name)

        def half(batch, kl_coeff, generator=None, noise=None):
            k = batch["velocity"].shape[0] // 2
            return losses({n: v[:k] for n, v in batch.items()}, kl_coeff, generator,
                          None if noise is None else noise[:k])
        return half

    monkeypatch.setattr(t, "make_loss_fn", make)


CASES = [("ldm-published.ddim50-b16", altered_answers),
         ("ldm-published.dpm10-b8", altered_answers),
         ("ldm-published.serve-ddim50-raw", altered_answers),
         ("vae-published.stage1-b2", unchanged_state),
         ("vae-published.stage1-b2", half_batch)]


@pytest.mark.parametrize("cell, fault", CASES, ids=lambda c: getattr(c, "__name__", c))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run.execute(BENCH, tiny.ctx(cell))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(cell):
    res = run.execute(BENCH, tiny.ctx(cell))
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks" and set(res["metrics"]) >= {"setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
