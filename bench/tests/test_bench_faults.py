"""The check catches what it is for: the rest of a run at a tiny size on
the CPU (the look for a chip skipped) with the timed path broken underneath
comes out not correct, and so does the control (the reference in float8 in
the program's place), each against the cell's own limits."""

import numpy as np
import pytest

from bench import judge, readings, run
from bench.tests.tiny import tiny_ctx

SEED = 2**31 + 21


def _run(ctx, seconds=0.3):
    result, _ = run.run_cell(ctx, seconds, False, device="cpu")
    return result


def unchanged_state(make_train_step):
    """``make_train_step`` whose steps return the state as they got it."""
    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def faulty(params, opt, batch):
            return (params, opt, step(params, opt, batch)[2])
        return faulty
    return make


@pytest.mark.parametrize("fault", [unchanged_state, readings.half_batch], ids=["unchanged", "half_batch"])
def test_training_faults_are_not_correct(fault):
    from repro_torch.train import step as step_mod

    ctx = tiny_ctx("hymba-1.5b.train", SEED)
    with readings.patched(step_mod, "make_train_step", fault):
        assert _run(ctx)["correct"] is False


def altered_token(generate):
    """``ServeEngine.generate`` with every token altered where it is
    produced: the id before the one chosen (1 for 0)."""
    def faulty(self, batch, max_new=16):
        res = generate(self, batch, max_new)
        res.tokens = np.where(res.tokens == 0, 1, res.tokens - 1).astype(res.tokens.dtype)
        return res
    return faulty


def half_served(generate):
    """``ServeEngine.generate`` serving half of the batch; the rest given
    the first half's answers."""
    def faulty(self, batch, max_new=16):
        b = batch["tokens"].shape[0]
        res = generate(self, {"tokens": batch["tokens"][: b // 2]}, max_new)
        res.tokens = np.concatenate([res.tokens, res.tokens], axis=0)
        return res
    return faulty


@pytest.mark.parametrize("fault", [altered_token, half_served], ids=["altered_token", "half_batch"])
@pytest.mark.parametrize("workload", ["mixtral-8x22b.prefill", "mixtral-8x22b.decode"])
def test_serving_faults_are_not_correct(workload, fault):
    from repro_torch.models.serve_llm import ServeEngine

    ctx = tiny_ctx(workload, SEED)
    with readings.patched(ServeEngine, "generate", fault):
        assert _run(ctx)["correct"] is False


def test_training_control_is_not_correct():
    ctx = tiny_ctx("hymba-1.5b.train", SEED)
    assert ctx.limits
    out = readings.train_readings(ctx, "cpu", control=True, half=False)
    assert judge.decide(out["control"][0], ctx.limits)[0] is False


@pytest.mark.parametrize("workload", ["mixtral-8x22b.prefill", "mixtral-8x22b.decode"])
def test_serving_control_is_not_correct(workload):
    ctx = tiny_ctx(workload, SEED)
    assert ctx.limits
    out = readings.serve_readings(ctx, "cpu", 0.3, control=True)
    assert judge.decide(out["control"][0], ctx.limits)[0] is False


@pytest.mark.parametrize("workload", ["hymba-1.5b.train", "mixtral-8x22b.prefill",
                                      "mixtral-8x22b.decode"])
def test_a_sound_run_is_correct(workload):
    ctx = tiny_ctx(workload, SEED)
    result = _run(ctx)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(ctx.limits)
