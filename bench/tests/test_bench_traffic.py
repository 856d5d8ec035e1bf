"""The inputs and weights of a run are the seed's and only the seed's."""

import numpy as np
import pytest
import torch

from bench.drivers import serve, train
from bench.tests.tiny import tiny_ctx
from bench.weights import allocate, fill

SEED = 2**31 + 11


@pytest.mark.parametrize("workload", ["hymba-1.5b.train"])
def test_train_batches_follow_the_seed(workload):
    a, b = tiny_ctx(workload, SEED), tiny_ctx(workload, SEED + 1)
    x, y = train.batches(a, "cpu"), train.batches(tiny_ctx(workload, SEED), "cpu")
    assert torch.equal(x, y)
    assert not torch.equal(x, train.batches(b, "cpu"))
    # every step's rows differ from every other's
    rows = x.reshape(-1, x.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert int(x.min()) >= 0 and int(x.max()) < a.cfg["vocab"]


@pytest.mark.parametrize("workload", ["mixtral-8x22b.prefill", "mixtral-8x22b.decode"])
def test_prompts_follow_the_seed(workload):
    a = serve.prompts(tiny_ctx(workload, SEED))
    assert np.array_equal(a, serve.prompts(tiny_ctx(workload, SEED)))
    assert not np.array_equal(a, serve.prompts(tiny_ctx(workload, SEED + 1)))
    assert a.shape[1:] == (tiny_ctx(workload, SEED).traffic["batch"],
                           tiny_ctx(workload, SEED).traffic["prompt"])


def test_large_seeds_give_distinct_derived_seeds():
    seeds = {tiny_ctx("hymba-1.5b.train", s).data_seed for s in (0, 1, 2**31, 2**31 + 1, 2**33)}
    assert len(seeds) == 5


@pytest.mark.parametrize("workload", ["hymba-1.5b.train", "mixtral-8x22b.decode"])
def test_weights_follow_the_seed(workload):
    ctx = tiny_ctx(workload, SEED)
    w1, w2, w3 = (allocate(ctx.plist, "cpu") for _ in range(3))
    fill(w1, ctx.plist, SEED)
    fill(w2, ctx.plist, SEED)
    fill(w3, ctx.plist, SEED + 1)
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    assert not torch.equal(w1["embed"], w3["embed"])
    for name, shape, dt, init, _ in ctx.plist:
        if init == "ones":
            assert bool((w1[name] == 1).all())
        if init == "decay":
            assert bool(((w1[name] <= -0.5) & (w1[name] > -1.5)).all())


def test_fill_refuses_a_target_that_is_not_the_references():
    ctx = tiny_ctx("hymba-1.5b.train", SEED)
    w = allocate(ctx.plist, "cpu")
    w["extra"] = torch.empty(1)
    with pytest.raises(ValueError):
        fill(w, ctx.plist, SEED)
