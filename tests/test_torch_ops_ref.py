"""The port's LLM entry points and oracles against the reference's names.

``repro_torch.kernels.ops.{flash_attention, ssm_scan, rwkv6}`` on CPU
tensors (the kernels' plain versions) against ``repro.kernels.ops``'s (the
Pallas kernels in interpret mode), and ``repro_torch.kernels.ref.
{attention_ref, ssm_scan_ref, rwkv6_ref}`` against ``repro.kernels.ref``'s,
on the same numpy-seeded float32 inputs.  Tolerances: 2e-4 for attention;
the scan's and wkv6's those of ``tests/test_torch_llm_kernels.py`` (2e-4 in
float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(rng, shapes):
    arrays = [np.asarray(make(rng, shape), np.float32) for make, shape in shapes]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _normal(scale=1.0):
    return lambda rng, shape: rng.normal(0, scale, shape)


def _uniform(lo, hi):
    return lambda rng, shape: rng.uniform(lo, hi, shape)


# name -> (the port's function, the reference's, input shapes, keyword arguments)
CASES = {
    "flash_attention": (ops.flash_attention, jops.flash_attention,
                        [(_normal(), (1, 4, 128, 64)), (_normal(), (1, 2, 128, 64)),
                         (_normal(), (1, 2, 128, 64))], dict(window=48)),
    "attention_ref": (ref.attention_ref, jref.attention_ref,
                      [(_normal(), (2, 4, 40, 16)), (_normal(), (2, 2, 56, 16)),
                       (_normal(), (2, 2, 56, 16))], dict(causal=False, softcap=5.0)),
    "ssm_scan": (ops.ssm_scan, jops.ssm_scan,
                 [(_normal(), (1, 2, 128, 16)), (_uniform(0.01, 0.2), (1, 2, 128)),
                  (_uniform(0.7, 0.999), (1, 2, 128)), (_normal(), (1, 128, 8)),
                  (_normal(), (1, 128, 8))], {}),
    "ssm_scan_ref": (ref.ssm_scan_ref, jref.ssm_scan_ref,
                     [(_normal(), (2, 3, 40, 8)), (_uniform(0.01, 0.2), (2, 3, 40)),
                      (_uniform(0.7, 0.999), (2, 3, 40)), (_normal(), (2, 40, 4)),
                      (_normal(), (2, 40, 4))], {}),
    "rwkv6": (ops.rwkv6, jops.rwkv6,
              [(_normal(0.5), (1, 2, 64, 16)), (_normal(0.5), (1, 2, 64, 16)),
               (_normal(), (1, 2, 64, 16)), (_uniform(0.5, 0.999), (1, 2, 64, 16)),
               (_normal(0.5), (2, 16))], {}),
    "rwkv6_ref": (ref.rwkv6_ref, jref.rwkv6_ref,
                  [(_normal(0.5), (2, 2, 40, 8)), (_normal(0.5), (2, 2, 40, 8)),
                   (_normal(), (2, 2, 40, 12)), (_uniform(0.5, 0.999), (2, 2, 40, 8)),
                   (_normal(0.5), (2, 8))], {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_llm_names_match_the_references(name):
    port, reference, shapes, kw = CASES[name]
    jargs, targs = _inputs(np.random.default_rng(len(name)), shapes)
    got, want = port(*targs, **kw), reference(*jargs, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
